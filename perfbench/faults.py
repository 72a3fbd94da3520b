"""Faults planted under the timed path, to show that `correct` comes out
false for each fault the search stage can have (the cell runs on one card,
so there is no exchange between chips to leave out). Each acts on one of
run_search's loops (`PATHS`): the pool's, the bucketed one-shot loop's, or
both.

- ``answer_altered_in_k4``: K4's output altered where it is produced,
  every emitted start moved by one (``ops/anchor_pool.pool_search``);
- ``answer_altered_in_host_redo``: the host engine's redone lists altered
  the same way (``pipeline/search.host_search_batch``);
- ``half_the_batch_left_out``: the pool's ``pump`` returns every second
  finished read only;
- ``state_returned_unchanged``: ``pump`` advances but, from its first
  finished chunk on, returns that chunk's results again and again;
- ``answer_altered_in_collect``: the one-shot engine's answers altered
  where the searcher makes them into lists, every start moved by one
  (``pipeline/search._DeviceSearcher.collect``);
- ``half_the_collected_batch_left_out``: ``collect`` returns every second
  read's answer only;
- ``collected_batch_returned_again``: from its second call on, ``collect``
  returns the answers of the call before it in place of its own.

The host redo's fault reaches the one-shot loop only through a searcher
made while it is planted (the searcher binds its host engine when made).
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


def _collect_altered(orig):
    def collect(self, handle, defer_redo=False):
        res, d = orig(self, handle, defer_redo=True)
        res = [None if r is None else [(q + 1, n) for q, n in r]
               for r in res]
        return _as_asked(res, d, defer_redo)
    return collect


def _collect_dropping_half(orig):
    def collect(self, handle, defer_redo=False):
        res, d = orig(self, handle, defer_redo=True)
        return _as_asked(res[::2], d, defer_redo)
    return collect


def _collect_stale(orig):
    def collect(self, handle, defer_redo=False):
        res, d = orig(self, handle, defer_redo=True)
        prev = getattr(self, "_stale_collect", None)
        self._stale_collect = (res, d)
        if prev is not None:
            res, d = prev
        return _as_asked(res, d, defer_redo)
    return collect


def _as_asked(res, d, defer_redo):
    """collect's return for its caller's `defer_redo`."""
    if defer_redo:
        return res, d
    if d is not None:
        for i, r in zip(d[0], d[1].result()):
            if i < len(res):
                res[i] = r
    return res


FAULTS = {
    "answer_altered_in_k4": ("svdss_tpu_torch.ops.anchor_pool",
                             "pool_search", _pool_search_altered),
    "answer_altered_in_host_redo": ("svdss_tpu_torch.pipeline.search",
                                    "host_search_batch", _redo_altered),
    "half_the_batch_left_out": ("svdss_tpu_torch.ops.anchor_pool:AnchorPool",
                                "pump", _pump_dropping_half),
    "state_returned_unchanged": ("svdss_tpu_torch.ops.anchor_pool:AnchorPool",
                                 "pump", _pump_stale),
    "answer_altered_in_collect": (
        "svdss_tpu_torch.pipeline.search:_DeviceSearcher", "collect",
        _collect_altered),
    "half_the_collected_batch_left_out": (
        "svdss_tpu_torch.pipeline.search:_DeviceSearcher", "collect",
        _collect_dropping_half),
    "collected_batch_returned_again": (
        "svdss_tpu_torch.pipeline.search:_DeviceSearcher", "collect",
        _collect_stale),
}
# the loops each fault acts on: "pool" (PoolDriver), "bucket" (BucketDriver)
PATHS = {"answer_altered_in_k4": ("pool",),
         "answer_altered_in_host_redo": ("pool", "bucket"),
         "half_the_batch_left_out": ("pool",),
         "state_returned_unchanged": ("pool",),
         "answer_altered_in_collect": ("bucket",),
         "half_the_collected_batch_left_out": ("bucket",),
         "collected_batch_returned_again": ("bucket",)}


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
