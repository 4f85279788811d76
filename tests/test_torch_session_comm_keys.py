"""A checkpoint's ``comm`` keys outside ``COMM_KEYS`` (ROADMAP Queue 3):
``SessionState.from_tree`` drops them, as the reference's
``_comm_restore`` reads its six keys with ``snap.get`` and ignores the
rest, and keeps the known ones; a save and restore round trip of such a
state reads back the same known keys."""
import numpy as np
import torch

from repro_torch.core.engine import COMM_KEYS, SessionState


def _state(comm):
    return SessionState(w=torch.full((6,), 1 / 6), key=np.array(
        [0, 7], np.uint32), round=2, comm=comm)


def test_unknown_comm_keys_are_ignored_on_load(tmp_path):
    comm = {"releases": {"0": 3}, "ledger_bits": 1024,
            "exhausted": False, "later_channel_state": [1, 2]}
    tree, meta = _state(comm).to_tree()
    got = SessionState.from_tree(tree, meta)
    assert got.comm == {k: v for k, v in comm.items() if k in COMM_KEYS}
    only_unknown = dict(meta, comm={"later_channel_state": 1})
    assert SessionState.from_tree(tree, only_unknown).comm is None
    _state(comm).save(str(tmp_path), step=2)
    back = SessionState.restore(str(tmp_path), device="cpu")
    assert back.comm == got.comm and back.round == 2
    assert torch.equal(back.w, got.w)
