"""The program's device search engines as the benchmark reads them: each
kernel's name in a trace, the module whose ``launches`` counter counts its
launches, and the work counters of the one-shot engines.

- K2 ``pingpong_fm_kernel`` (``ops/pingpong.py``): the FM walk;
- K3 ``anchor_batch_kernel`` (``ops/anchor_device.py``): narrow anchor
  tables, one shot;
- K4 ``anchor_pool_kernel`` (``ops/anchor_pool.py``): narrow anchor tables,
  the pool (which keeps its own work counters, ``AnchorPool._work``);
- K5 ``anchor_wide_kernel`` (``ops/anchor_wide_device.py``): wide anchor
  tables, one shot or in parked-phase waves.
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch

KERNELS = {"K2": "pingpong_fm_kernel", "K3": "anchor_batch_kernel",
           "K4": "anchor_pool_kernel", "K5": "anchor_wide_kernel"}
MODULES = {"K2": "svdss_tpu_torch.ops.pingpong",
           "K3": "svdss_tpu_torch.ops.anchor_device",
           "K4": "svdss_tpu_torch.ops.anchor_pool",
           "K5": "svdss_tpu_torch.ops.anchor_wide_device"}
# K2's work tensor: the rank steps its lanes took, the jump-table rows they
# read (ops/pingpong.py batch_search)
K2_WORK_FIELDS = ("rank_steps", "jump_rows")
# the names pipeline/search.py calls each one-shot engine by, and where the
# padded reads [Q, L + 1] stand among the positional arguments
ENTRIES = {"batch_search": ("K2", 1), "batch_search_anchor": ("K3", 2),
           "batch_search_anchor_wide": ("K5", 2), "WideWaveRun": ("K5", 2)}


def launches() -> Dict[str, int]:
    """Each kernel's launches since its module was loaded."""
    return {k: importlib.import_module(m).launches
            for k, m in MODULES.items()}


def work_fields(kernel: str):
    if kernel == "K2":
        return K2_WORK_FIELDS
    return importlib.import_module(MODULES[kernel]).WORK_FIELDS


def table_bytes(*tables) -> Dict[str, int]:
    """Bytes of each tensor field of the searcher's device tables (the
    anchor tables' or the FM index's NamedTuple, the jump table), by
    field name."""
    out: Dict[str, int] = {}
    for t in tables:
        if isinstance(t, torch.Tensor):
            out["jump_table"] = int(t.numel() * t.element_size())
        elif t is not None:
            for k, v in t._asdict().items():
                if isinstance(v, torch.Tensor):
                    out[k] = int(v.numel() * v.element_size())
    return out


class OneShotWork:
    """The one-shot engines' work over a block. While it is open, each call
    the searcher makes into K2, K3 or K5 (by the names ``pipeline/search.py``
    calls them by) is handed a ``work`` tensor of that engine's own, the
    engines' measurement aid, which adds their work counters to it on the
    device; the lanes of each call are counted on the host. The results do
    not depend on it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.work = {k: torch.zeros(len(work_fields(k)), dtype=torch.int64,
                                    device=device) for k in ("K2", "K3", "K5")}
        self.lanes = {k: 0 for k in self.work}
        self._saved: Dict[str, object] = {}

    def _counted(self, name: str, orig):
        kernel, at = ENTRIES[name]
        work, lanes = self.work[kernel], self.lanes

        if isinstance(orig, type):
            class Counted(orig):
                def __init__(self, *a, **kw):
                    lanes[kernel] += int(a[at].shape[0])
                    super().__init__(*a, **dict(kw, work=work))
            return Counted

        def counted(*a, **kw):
            lanes[kernel] += int(a[at].shape[0])
            return orig(*a, **dict(kw, work=work))
        return counted

    def __enter__(self) -> "OneShotWork":
        from svdss_tpu_torch.pipeline import search
        for name in ENTRIES:
            self._saved[name] = getattr(search, name)
            setattr(search, name, self._counted(name, self._saved[name]))
        return self

    def __exit__(self, *exc) -> None:
        from svdss_tpu_torch.pipeline import search
        for name, orig in self._saved.items():
            setattr(search, name, orig)
        self._saved.clear()

    def sums(self, kernel: str) -> Optional[Dict[str, int]]:
        """The kernel's work counters over the block, or None when its
        engine took no call."""
        if not self.lanes[kernel]:
            return None
        return dict(zip(work_fields(kernel),
                        (int(x) for x in self.work[kernel].cpu().tolist())))
