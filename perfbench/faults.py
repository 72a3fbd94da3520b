"""Faults planted under the timed path, to show that `correct` comes out
false for each fault the search stage can have (the cell runs on one card,
so there is no exchange between chips to leave out):

- ``answer_altered_in_k4``: K4's output altered where it is produced,
  every emitted start moved by one (``ops/anchor_pool.pool_search``);
- ``answer_altered_in_host_redo``: the host engine's redone lists altered
  the same way (``pipeline/search.host_search_batch``);
- ``half_the_batch_left_out``: the pool's ``pump`` returns every second
  finished read only;
- ``state_returned_unchanged``: ``pump`` advances but, from its first
  finished chunk on, returns that chunk's results again and again.
"""

from __future__ import annotations

import contextlib
import importlib


def _pool_search_altered(orig):
    def pool_search(*a, **kw):
        res = orig(*a, **kw)
        res.qs.add_(1)
        return res
    return pool_search


def _redo_altered(orig):
    def host_search_batch(*a, **kw):
        return [[(q + 1, n) for q, n in r] for r in orig(*a, **kw)]
    return host_search_batch


def _pump_dropping_half(orig):
    def pump(self):
        return [r for i, r in enumerate(orig(self)) if i % 2 == 0]
    return pump


def _pump_stale(orig):
    def pump(self):
        got = orig(self)
        if got and not hasattr(self, "_stale_results"):
            self._stale_results = got
        return list(getattr(self, "_stale_results", got))
    return pump


FAULTS = {
    "answer_altered_in_k4": ("svdss_tpu_torch.ops.anchor_pool",
                             "pool_search", _pool_search_altered),
    "answer_altered_in_host_redo": ("svdss_tpu_torch.pipeline.search",
                                    "host_search_batch", _redo_altered),
    "half_the_batch_left_out": ("svdss_tpu_torch.ops.anchor_pool:AnchorPool",
                                "pump", _pump_dropping_half),
    "state_returned_unchanged": ("svdss_tpu_torch.ops.anchor_pool:AnchorPool",
                                 "pump", _pump_stale),
}


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in place while the block runs."""
    where, attr, wrap = FAULTS[name]
    mod, _, cls = where.partition(":")
    owner = importlib.import_module(mod)
    if cls:
        owner = getattr(owner, cls)
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)
