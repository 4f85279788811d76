"""End-to-end example: train the ~100M-parameter preset LM for a few
hundred steps on synthetic token streams with the ignorance-weighted loss,
on the card (the weighted-CE kernels carry the loss).

Counterpart of ``examples/train_lm_100m.py``.  Equivalent CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m --steps 300

Any other flag of the CLI passes through (``--device cpu``, ``--seed``);
on the CPU pass ``--steps`` to trim.
"""
import sys

from repro_torch.launch.train import main as train_main


def argv(args: list) -> list:
    """The CLI's arguments: ``args``, ``--steps 300`` unless a step count
    is given, then ``--preset 100m``."""
    out = list(args)
    if not any(a.startswith("--steps") for a in out):
        out += ["--steps", "300"]
    return out + ["--preset", "100m"]


def main(args=None):
    """Train; returns the CLI's ``TrainRun``."""
    return train_main(argv(sys.argv[1:] if args is None else args))


if __name__ == "__main__":
    main()
