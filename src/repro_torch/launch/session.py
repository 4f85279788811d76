"""Session driver: run an ASCII engine session of the port from the command
line, on the card by default.

Counterpart of ``repro/launch/session.py``, its eager subset: wires a
dataset, a scheduler (via the variant name), a transport with its wire
channel and a learner into ``core.engine.Protocol``, with optional mid-run
checkpointing and resume.

  PYTHONPATH=src python -m repro_torch.launch.session --dataset blob3 \
      --variant ascii --rounds 6 --transport metered
  PYTHONPATH=src python -m repro_torch.launch.session --ckpt-dir runs/sess \
      --stop-after 2                       # save mid-run ...
  PYTHONPATH=src python -m repro_torch.launch.session --ckpt-dir runs/sess \
      --resume                             # ... and pick the run back up
  PYTHONPATH=src python -m repro_torch.launch.session --codec int4 \
      --serve-codec int8 --dp-epsilon 1 --accountant rdp   # a wire channel
  PYTHONPATH=src python -m repro_torch.launch.session --byte-budget 20000
  PYTHONPATH=src python -m repro_torch.launch.session --controller entropy \
      --serve-controller margin            # the control plane
  PYTHONPATH=src python -m repro_torch.launch.session --variant async \
      --codec int8                         # stale-read async rounds
  PYTHONPATH=src python -m repro_torch.launch.session --learner mlp
  PYTHONPATH=src python -m repro_torch.launch.session --learner logistic \
      --backend compiled                   # the session as one program
  PYTHONPATH=src python -m repro_torch.launch.session --protocol fedavg \
      --learner logistic --scenario churn --codec int8   # FedAvg, churn
  PYTHONPATH=src python -m repro_torch.launch.session --protocol al \
      --partition dirichlet --skew 0.3     # Assisted Learning, non-IID
  PYTHONPATH=src python -m repro_torch.launch.session --variant async \
      --clock-skew 0,0,2,1                 # stale reads lagging barriers
  PYTHONPATH=src python -m repro_torch.launch.session --trace run.jsonl \
      --metrics-out run.prom --profile-dir prof --watch   # telemetry
  PYTHONPATH=src python -m repro_torch.launch.session --device cpu

It prints the reference's ``dataset,[protocol,]variant,transport,
rounds=..,components=..|params=..,acc=..[,bits=..]`` line, its ``serve:``
line (ASCII only) and its channel
lines (``controller: ..``, ``codec=..``, ``serve_codec=..``,
``serve_controller: ..``, ``budget: ..``, ``dp: ..``).  The
data are drawn from a ``torch.Generator`` seeded with ``--seed``, so the
numbers differ from the reference CLI's.  ``--trace`` streams a JSONL
telemetry trace (spans as they close, the metrics at the end),
``--metrics-out`` writes the registry (``.prom``: Prometheus text, else a
JSON snapshot), ``--profile-dir`` runs the session under
``torch.profiler.profile`` (CPU and CUDA activities, the spans as
``record_function`` ranges) and writes its Chrome trace there, and
``--watch`` draws the live dashboard on stderr.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
from dataclasses import dataclass

import torch

from repro_torch.comm import (BudgetSpec, BudgetedTransport,
                              GaussianMechanism, make_codec)
from repro_torch.control import (AdaptiveController, BudgetAwareScheduler,
                                  ServeController, make_accountant)
from repro_torch.control.adaptive import SERVE_STATS
from repro_torch.control.adaptive import STATS as CONTROLLER_STATS
from repro_torch.core.engine import (InProcessTransport, MeshRingTransport,
                                     MeteredTransport, Protocol, Session,
                                     SessionConfig, Transport, endpoints_for,
                                     variant_setup)
from repro_torch.data import synthetic
from repro_torch.data.partition import train_test_split, vertical_split
from repro_torch.device import resolve_device
from repro_torch.learners.logistic import LogisticRegression
from repro_torch.learners.mlp import MLP
from repro_torch.learners.tree import DecisionTree
from repro_torch.scenarios import (PARTITIONS, PRESETS, PROTOCOLS, Scenario,
                                   make_variant)
from repro_torch.telemetry import Telemetry

DATASETS = {
    "blob3": lambda gen, n, dev: synthetic.blob_fig3(gen, n=n, device=dev),
    "blob4": lambda gen, n, dev: synthetic.blob_fig4(gen, n=n, device=dev),
    "blob6": lambda gen, n, dev: synthetic.blob_fig6(gen, n=n, device=dev),
    "wine": lambda gen, n, dev: synthetic.wine_surrogate(gen, device=dev),
}

TRANSPORTS = {
    "inprocess": InProcessTransport,
    "metered": MeteredTransport,
    "meshring": MeshRingTransport,
}

LEARNERS = {
    "tree": lambda args: DecisionTree(depth=args.depth, num_thresholds=8,
                                      device=args.device),
    "logistic": lambda args: LogisticRegression(steps=args.steps,
                                                device=args.device),
    "mlp": lambda args: MLP(hidden=(32, 16), steps=args.steps,
                            device=args.device),
}

# the run config that must match across pause/resume, with the defaults a
# manifest written before a key existed implies
RUN_KEYS = ("dataset", "n", "variant", "learner", "depth", "steps", "seed",
            "codec", "serve_codec", "byte_budget", "dp_epsilon", "controller",
            "accountant", "scheduler", "serve_controller", "protocol",
            "scenario", "subsample", "dropout", "straggle", "partition",
            "skew", "clock_skew", "scenario_seed")
RUN_DEFAULTS = {"codec": "", "serve_codec": "", "byte_budget": 0,
                "dp_epsilon": 0.0, "controller": "", "accountant": "basic",
                "scheduler": "", "serve_controller": "", "protocol": "ascii",
                "scenario": "", "subsample": 0.0, "dropout": 0.0,
                "straggle": 0.0, "partition": "iid", "skew": 0.5,
                "clock_skew": "", "scenario_seed": 0}
CODEC_NAMES = ["", "fp32", "fp16", "int8", "int4", "topk"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="blob3", choices=sorted(DATASETS))
    ap.add_argument("--n", type=int, default=600)
    ap.add_argument("--variant", default="ascii",
                    choices=["ascii", "simple", "random", "async"])
    ap.add_argument("--protocol", default="ascii", choices=sorted(PROTOCOLS),
                    help="protocol variant: ascii (the ignorance "
                         "interchange), fedavg (federated averaging over a "
                         "homogeneous functional roster, GradientMsg "
                         "uplinks through the same channel) or al "
                         "(assisted-learning residual rounds, ResidualMsg "
                         "around the ring, eager only)")
    ap.add_argument("--scenario", default="", choices=[""] + sorted(PRESETS),
                    help="deployment-reality preset (clean, noniid, churn, "
                         "subsample); fixes the knob flags below")
    ap.add_argument("--subsample", type=float, default=0.0,
                    help="per-round client subsampling fraction in (0, 1] "
                         "(FedAvg's C; unlocks --accountant subsampled-rdp)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-round permanent-departure probability")
    ap.add_argument("--straggle", type=float, default=0.0,
                    help="per-(round, agent) transient-miss probability")
    ap.add_argument("--partition", default="iid", choices=sorted(PARTITIONS),
                    help="non-IID horizontal shards: dirichlet label skew "
                         "or power-law quantity skew (agents fit only on "
                         "their shard's rows)")
    ap.add_argument("--skew", type=float, default=0.5,
                    help="partition skew: dirichlet alpha / quantity "
                         "exponent")
    ap.add_argument("--clock-skew", default="",
                    help="comma-separated per-agent barrier lags (ASCII "
                         "--variant async only), e.g. 0,0,2,1")
    ap.add_argument("--scenario-seed", type=int, default=0,
                    help="seed of the scenario's churn and partition draws")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--transport", default="metered",
                    choices=sorted(TRANSPORTS))
    ap.add_argument("--learner", default="tree", choices=sorted(LEARNERS))
    ap.add_argument("--depth", type=int, default=3,
                    help="tree depth (tree learner only)")
    ap.add_argument("--steps", type=int, default=150,
                    help="optimizer steps (logistic/mlp learners)")
    ap.add_argument("--codec", default="", choices=CODEC_NAMES,
                    help="wire codec for outgoing ignorance scores (the "
                         "ledger books encoded bits; empty = raw fp32)")
    ap.add_argument("--serve-codec", default="", choices=CODEC_NAMES,
                    help="wire codec for prediction-time score blocks "
                         "(defaults to --codec)")
    ap.add_argument("--byte-budget", type=int, default=0,
                    help="session byte budget: degrade down the "
                         "fp32>fp16>int8>int4 ladder, then skip hops and "
                         "stop scheduling rounds (the budgeted metered "
                         "transport; excludes --transport and the codecs)")
    ap.add_argument("--dp-epsilon", type=float, default=0.0,
                    help="per-release DP epsilon: Gaussian-mechanism noise "
                         "on every outgoing vector, accounted per agent")
    ap.add_argument("--controller", default="",
                    choices=[""] + list(CONTROLLER_STATS),
                    help="adaptive codec controller: pick the codec rung "
                         "per hop from this statistic of the outgoing "
                         "ignorance vector (resid = hop innovation, "
                         "entropy/l2 = concentration); replaces --codec "
                         "and floors the --byte-budget walk")
    ap.add_argument("--serve-controller", default="",
                    choices=[""] + list(SERVE_STATS),
                    help="serve-path controller: pick each score block's "
                         "codec rung from its uncertainty (margin = mean "
                         "top-2 gap, entropy = row entropy); replaces "
                         "--serve-codec and floors the --byte-budget walk")
    ap.add_argument("--scheduler", default="", choices=["", "budget-aware"],
                    help="round-order override: budget-aware orders the "
                         "agents each round by the bits they have spent "
                         "(sequential variants)")
    ap.add_argument("--accountant", default="basic",
                    choices=["basic", "rdp", "subsampled-rdp"],
                    help="privacy accountant for --dp-epsilon releases: "
                         "basic additive or Renyi-DP composition, or "
                         "subsampled-rdp: RDP amplified by the scenario's "
                         "--subsample rate (capped at the full-batch "
                         "bound)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint SessionState here after the run "
                         "(or after --stop-after rounds)")
    ap.add_argument("--stop-after", type=int, default=0,
                    help="pause after this many rounds (with --ckpt-dir: "
                         "save a resumable checkpoint and exit)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from --ckpt-dir instead of starting fresh")
    ap.add_argument("--trace", default="",
                    help="stream a JSONL telemetry trace here: spans as "
                         "they close, the final metrics when the run ends "
                         "(a killed run leaves a prefix that `python -m "
                         "repro_torch.telemetry.check --allow-partial` "
                         "accepts)")
    ap.add_argument("--metrics-out", default="",
                    help="write the final metrics registry here (.prom: "
                         "Prometheus text, else a JSON snapshot)")
    ap.add_argument("--profile-dir", default="",
                    help="run the session under torch.profiler (CPU and "
                         "CUDA activities) and write its Chrome trace into "
                         "this directory; the session/round/hop spans are "
                         "ranges on its timeline")
    ap.add_argument("--watch", action="store_true",
                    help="draw the live dashboard on stderr while the "
                         "session runs (per-round bits, skips, exhaustion; "
                         "the compiled program's rounds through its live "
                         "taps)")
    ap.add_argument("--backend", default="eager",
                    choices=["eager", "compiled"],
                    help="eager: the host loop; compiled: the whole session "
                         "as one fixed-shape program with no host read "
                         "(functional learners, sequential or budget-aware "
                         "order, no checkpointing; fedavg lowers its "
                         "scenarios too), its ledger replayed")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the whole session (default cuda; "
                         "raises when no card is present)")
    return ap


@dataclass
class Run:
    """What one CLI run produced (for callers that drive it in-process).
    ``session`` is None for a protocol variant's compiled run, which has
    no live session; ``fitted`` is the trained result either way."""
    session: Session | None
    transport: Transport
    line: str
    paused: bool
    fitted: object = None
    telemetry: Telemetry | None = None


def check_args(args: argparse.Namespace) -> None:
    """The reference CLI's argument rules for the backend, the wire
    channel, the protocol and the scenario flags; a broken rule exits with
    its message.  The scenario's own rules are :func:`make_scenario`'s."""
    if args.backend == "compiled":
        if args.resume or args.stop_after or args.ckpt_dir:
            raise SystemExit("--backend compiled runs fit-to-completion with "
                             "no SessionState; checkpointing/pause/resume "
                             "need the eager backend")
        if args.learner == "tree":
            raise SystemExit("--backend compiled needs a functional learner "
                             "(--learner logistic|mlp); tree is eager-only")
        if args.variant not in ("ascii", "simple", "async"):
            raise SystemExit("--backend compiled supports sequential, "
                             "budget-aware and async-stale scheduling "
                             "(--variant ascii|simple|async)")
    if args.byte_budget > 0:
        if args.codec:
            raise SystemExit("--byte-budget drives codec choice through its "
                             "degradation ladder; drop --codec")
        if args.serve_codec:
            raise SystemExit("--byte-budget drives the serve codec through "
                             "the same degradation ladder; drop "
                             "--serve-codec")
        if args.transport != "metered":
            raise SystemExit("--byte-budget needs the (budgeted) metered "
                             "transport; drop --transport")
    if args.variant == "async" and args.controller:
        raise SystemExit("adaptive controllers are per-hop rung policies "
                         "with no async analogue; --variant async releases "
                         "its barrier merge once per round (--codec/"
                         "--byte-budget/--dp-epsilon apply per barrier and "
                         "are supported)")
    if args.controller and args.codec:
        raise SystemExit("--controller drives codec choice through its "
                         "ladder; drop --codec")
    if args.serve_controller and args.serve_codec:
        raise SystemExit("--serve-controller drives serve codec choice "
                         "through its ladder; drop --serve-codec")
    if args.scheduler == "budget-aware" \
            and args.variant not in ("ascii", "simple"):
        raise SystemExit("--scheduler budget-aware replaces the round "
                         "order; use a sequential variant (ascii|simple)")
    if args.accountant != "basic" and args.dp_epsilon <= 0:
        raise SystemExit(f"--accountant {args.accountant} accounts "
                         f"--dp-epsilon releases; set --dp-epsilon too")
    if args.protocol != "ascii":
        if args.variant in ("simple", "async"):
            raise SystemExit(
                f"--variant {args.variant} is an ASCII scheduling mode; "
                f"--protocol {args.protocol} runs its own round rule over an "
                f"ordered roster (--variant ascii|random)")
        if args.controller or args.serve_controller:
            raise SystemExit("adaptive controllers read ignorance-vector "
                             f"statistics; they do not apply to --protocol "
                             f"{args.protocol} traffic")
    if args.protocol == "fedavg" and args.learner == "tree":
        raise SystemExit("--protocol fedavg averages flat parameter deltas "
                         "from a functional learner core; --learner tree has "
                         "none (use logistic|mlp)")
    if args.protocol == "al" and args.backend == "compiled":
        raise SystemExit("--protocol al is eager-only: its ring of "
                         "closed-form ridge hops has no compiled lowering")
    if args.scenario and (args.subsample or args.dropout or args.straggle
                          or args.partition != "iid" or args.clock_skew):
        raise SystemExit("--scenario presets fix the scenario knobs; drop "
                         "the individual --subsample/--dropout/--straggle/"
                         "--partition/--clock-skew flags (or drop "
                         "--scenario)")
    if args.clock_skew and args.variant != "async":
        raise SystemExit("--clock-skew lags agents behind the stale-read "
                         "barrier; it needs --variant async")


def make_scenario(args: argparse.Namespace) -> Scenario:
    """The CLI's scenario (a preset or the knob flags), with the
    reference's rules for the accountant and the compiled backend."""
    if args.scenario:
        scenario = PRESETS[args.scenario]
    else:
        try:
            clock = (tuple(int(s) for s in args.clock_skew.split(","))
                     if args.clock_skew else ())
        except ValueError:
            raise SystemExit(f"--clock-skew wants comma-separated "
                             f"non-negative ints, got {args.clock_skew!r}")
        try:
            scenario = Scenario("cli", subsample=args.subsample or None,
                                dropout=args.dropout, straggle=args.straggle,
                                partition=args.partition, skew=args.skew,
                                clock_skew=clock, seed=args.scenario_seed)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.accountant == "subsampled-rdp" and scenario.subsample is None:
        raise SystemExit("--accountant subsampled-rdp amplifies privacy by "
                         "the client-sampling rate; set --subsample (or a "
                         "subsampling --scenario) so there is a rate to "
                         "amplify by")
    if args.backend == "compiled" and args.protocol == "ascii" \
            and not scenario.trivial:
        raise SystemExit("--backend compiled does not lower ASCII scenario "
                         "knobs (churn changes the chain's shape per round); "
                         "use the eager backend — fedavg scenarios do "
                         "compile")
    return scenario


def make_transport(args: argparse.Namespace,
                   scenario: Scenario | None = None) -> Transport:
    """The CLI's transport with its wire channel.  The Gaussian mechanism
    clamps at zero for ASCII's nonnegative scores only (FedAvg's deltas and
    AL's residuals are signed); the accountant takes the scenario's
    subsampling rate."""
    privacy = (GaussianMechanism(epsilon=args.dp_epsilon,
                                 nonneg=(args.protocol == "ascii"))
               if args.dp_epsilon > 0 else None)
    q = None if scenario is None else scenario.subsample
    accountant = (make_accountant(args.accountant, q=q)
                  if privacy is not None else None)
    controller = (AdaptiveController(stat=args.controller)
                  if args.controller else None)
    serve_controller = (ServeController(stat=args.serve_controller)
                        if args.serve_controller else None)
    if args.byte_budget > 0:
        return BudgetedTransport(BudgetSpec(session_bits=args.byte_budget * 8),
                                 privacy=privacy, controller=controller,
                                 accountant=accountant,
                                 serve_controller=serve_controller)
    return TRANSPORTS[args.transport](
        codec=make_codec(args.codec) if args.codec else None,
        privacy=privacy,
        serve_codec=make_codec(args.serve_codec) if args.serve_codec else None,
        controller=controller, accountant=accountant,
        serve_controller=serve_controller)


def make_scheduler(args: argparse.Namespace):
    """The CLI's scheduler and upstream flag: the variant's, or the
    budget-aware override."""
    scheduler, upstream = variant_setup(args.variant, args.seed)
    if args.scheduler == "budget-aware":
        scheduler = BudgetAwareScheduler()
    return scheduler, upstream


def _print_comm(transport: Transport) -> None:
    """Wire-channel summary lines (controller, codec ledger, budget state,
    DP spend)."""
    if transport.controller is not None:
        print(f"controller: stat={transport.controller.stat},"
              f"rungs={len(transport.controller.ladder)},"
              f"ema={float(transport.ctrl_state):.4f}")
    if transport.codec is not None:
        line = f"codec={type(transport.codec).__name__}"
        if isinstance(transport, MeteredTransport):
            line += (f",ignorance_bits="
                     f"{transport.bits_by_kind().get('ignorance', 0)}")
        print(line)
    if transport.serve_codec is not None:
        print(f"serve_codec={type(transport.serve_codec).__name__}")
    if transport.serve_controller is not None:
        print(f"serve_controller: stat={transport.serve_controller.stat},"
              f"rungs={len(transport.serve_controller.ladder)}")
    if isinstance(transport, BudgetedTransport):
        print(f"budget: spent={transport.total_bits}b,"
              f"skipped_hops={len(transport.skipped)},"
              f"exhausted={transport.exhausted}")
    if transport.privacy is not None:
        print(f"dp: {json.dumps(transport.accountant.report(transport.privacy))}")


def _print_serve(transport: Transport, preds: torch.Tensor,
                 cte: torch.Tensor, before_bits: int) -> None:
    """Serve-path summary: distributed-prediction accuracy and the encoded
    score-block bits this predict call booked."""
    line = (f"serve: acc="
            f"{float(torch.mean((preds == cte).to(torch.float32))):.3f}")
    if isinstance(transport, MeteredTransport):
        bits = transport.bits_by_kind().get("score_block", 0) - before_bits
        line += f",score_block_bits={bits}"
    if isinstance(transport, BudgetedTransport):
        line += f",skipped_hops={len(transport.skipped)}"
    print(line)


def make_telemetry(args: argparse.Namespace):
    """The run's Telemetry (None without a telemetry flag), its trace
    streaming when ``--trace`` is set, and the ``--watch`` dashboard."""
    if not (args.trace or args.metrics_out or args.profile_dir
            or args.watch):
        return None, None
    telemetry = Telemetry(profile=bool(args.profile_dir), live=args.watch)
    if args.trace:
        telemetry.stream_trace(args.trace)
    dash = None
    if args.watch:
        from repro_torch.telemetry.dash import Dashboard
        dash = Dashboard(telemetry.registry,
                         title=f"session:{args.dataset}").attach(
                             telemetry.live)
    return telemetry, dash


def _profiler(args: argparse.Namespace, device):
    """``torch.profiler.profile`` for ``--profile-dir`` (CPU activity, and
    CUDA on the card), else a no-op context."""
    if not args.profile_dir:
        return contextlib.nullcontext()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _finish_telemetry(args, telemetry, transport, dash, prof) -> None:
    """Write the profiler's trace, draw the dashboard's last frame and
    write the trace and metrics, after all traffic."""
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "session.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"profile: wrote {path}")
    if dash is not None:
        dash.final()
    if telemetry is not None:
        telemetry.write_artifacts(trace=args.trace or None,
                                  metrics_out=args.metrics_out or None,
                                  transport=transport)
        for path in (args.trace, args.metrics_out):
            if path:
                print(f"telemetry: wrote {path}")


def run(args: argparse.Namespace) -> Run:
    """Run (or resume) one session as the CLI does, printing its lines."""
    check_args(args)
    scenario = make_scenario(args)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    ds = DATASETS[args.dataset](gen, args.n, device)
    tr, te = train_test_split(args.seed, ds.X.shape[0])
    tr, te = torch.as_tensor(tr, device=device), torch.as_tensor(te,
                                                                 device=device)
    Xs = vertical_split(ds.X, ds.splits)
    Xtr, Xte = [x[tr] for x in Xs], [x[te] for x in Xs]
    ctr, cte = ds.classes[tr], ds.classes[te]

    scheduler, upstream = make_scheduler(args)
    variant = make_variant(args.protocol)
    try:
        scenario.validate(len(Xs), scheduler, variant)
    except ValueError as e:
        raise SystemExit(str(e))
    transport = make_transport(args, scenario)
    telemetry, dash = make_telemetry(args)
    engine = Protocol(SessionConfig(num_classes=ds.num_classes,
                                    max_rounds=args.rounds,
                                    upstream=upstream),
                      scheduler=scheduler, transport=transport,
                      backend=args.backend, variant=variant,
                      scenario=None if scenario.trivial else scenario,
                      telemetry=telemetry, device=device)
    endpoints = endpoints_for([LEARNERS[args.learner](args) for _ in Xs], Xtr)
    with _profiler(args, device) as prof:
        out = _drive(args, engine, endpoints, Xtr, ctr, Xte, cte, transport)
    _finish_telemetry(args, telemetry, transport, dash, prof)
    if out.paused:
        print(f"paused after {out.session.state.round} rounds"
              + ("; rerun with --resume to continue" if args.ckpt_dir
                 else "; nothing was saved (pass --ckpt-dir)"))
    out.telemetry = telemetry
    return out


def _drive(args, engine, endpoints, Xtr, ctr, Xte, cte, transport) -> Run:
    """Fit (or resume) the session, print its lines and serve (ASCII)."""
    run_cfg = {k: getattr(args, k) for k in RUN_KEYS}
    cfg_path = os.path.join(args.ckpt_dir or ".", "cli_config.json")
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume needs --ckpt-dir")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                saved = {**RUN_DEFAULTS, **json.load(f)}
            if saved != run_cfg:
                raise SystemExit(f"--resume config mismatch: checkpoint was "
                                 f"written with {saved}, this run is "
                                 f"{run_cfg}")
        else:
            print(f"warning: no {cfg_path} manifest; cannot verify that "
                  f"dataset/variant/seed match the saved session")
        session = engine.resume(args.ckpt_dir, endpoints, ctr)
        print(f"resumed {args.ckpt_dir} at round {session.state.round}")
    elif args.backend == "compiled":
        fitted = engine.fit(args.seed, endpoints, ctr)
        session = engine._session      # None for a protocol variant's run
    else:
        session = engine.start(args.seed, endpoints, ctr)

    paused = False
    if session is not None:
        if args.backend == "eager":
            session.run(max_rounds=args.stop_after or None)
        paused = bool(args.stop_after and not session.state.stopped
                      and session.state.round < args.rounds)
        if args.ckpt_dir:
            path = session.checkpoint(args.ckpt_dir)
            with open(cfg_path, "w") as f:
                json.dump(run_cfg, f)
            print(f"checkpointed round {session.state.round} -> {path}")
        fitted = session.fitted()

    acc = float(torch.mean((fitted.predict(Xte) == cte).to(torch.float32)))
    tag = "" if args.protocol == "ascii" else f"{args.protocol},"
    size = (f"params={fitted.g.numel()}" if args.protocol == "fedavg"
            else f"components={len(fitted.components)}")
    line = (f"{args.dataset},{tag}{args.variant},{args.transport},"
            f"rounds={fitted.num_rounds},{size},acc={acc:.3f}")
    if isinstance(transport, MeteredTransport):
        line += f",bits={transport.total_bits}"
    print(line)
    if not paused and args.protocol == "ascii":
        # only ASCII has a serve path (score blocks to the head), and only
        # the terminal run serves: the checkpoint above snapshots the
        # channel's spend first, so serving from a paused run would book
        # bits and DP releases the snapshot misses
        before = (transport.bits_by_kind().get("score_block", 0)
                  if isinstance(transport, MeteredTransport) else 0)
        preds = (engine.predict_distributed(Xte)
                 if args.backend == "compiled"
                 else session.predict_distributed(Xte))
        _print_serve(transport, preds, cte, before)
    _print_comm(transport)
    return Run(session, transport, line, paused, fitted)


def main(argv: list[str] | None = None) -> None:
    # float32 products in full float32 on the card, as the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
