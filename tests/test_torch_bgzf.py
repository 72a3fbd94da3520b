"""The port's `bgzf_read_all` (svdss_tpu_torch/io/native.py): the bytes of
the JAX package's copy, held once in memory.

The JAX package's function inflates into a C buffer and then copies it into
a numpy array, so its peak is twice the inflated size; the port hands out a
view over the C buffer itself."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from svdss_tpu.io import native as j_native
from svdss_tpu_torch.io import native
from svdss_tpu_torch.io.bam import BamReader
from svdss_tpu_torch.utils.simulate import (random_genome, simulate_reads,
                                            make_haplotype, write_bam)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="the native library is not built")


@pytest.fixture(scope="module")
def test_bam(tmp_path_factory):
    rng = np.random.default_rng(31)
    chroms = random_genome(rng, {"chrB": 30000})
    hap = make_haplotype(rng, "chrB", chroms["chrB"], n_ins=1, n_del=1,
                         min_len=60, max_len=120)
    recs = simulate_reads(rng, [hap], coverage=6, read_len=1500,
                          snv_rate=0.002, indel_rate=0.0005)
    path = tmp_path_factory.mktemp("bgzf") / "reads.bam"
    write_bam(str(path), chroms, recs)
    return str(path)


def test_bytes_equal_the_jax_copy(test_bam):
    got = native.bgzf_read_all(test_bam)
    want = j_native.bgzf_read_all(test_bam)
    assert isinstance(got, memoryview) and got.format == want.format == "B"
    assert len(got) == len(want) > 0
    assert got.tobytes() == want.tobytes()
    # the reader the smoother and the search stage hand it to
    recs = list(BamReader(got))
    assert len(recs) == len(list(BamReader(want))) > 0


def test_views_outlive_the_memoryview(test_bam):
    """The C buffer lives as long as any array or view made from it."""
    want = j_native.bgzf_read_all(test_bam).tobytes()
    arr = np.frombuffer(native.bgzf_read_all(test_bam), dtype=np.uint8)
    tail = arr[-100:]
    del arr
    junk = [np.full(1 << 16, 7, dtype=np.uint8) for _ in range(64)]
    assert tail.tobytes() == want[-100:] and len(junk) == 64


def test_empty_file_reads_as_empty(tmp_path):
    path = str(tmp_path / "empty.bgzf")
    assert native.bgzf_write_all(path, b"")
    got = native.bgzf_read_all(path)
    assert isinstance(got, memoryview) and len(got) == 0


PEAK_CHILD = r"""
import json, resource, sys
import numpy as np
from svdss_tpu_torch.io import native
native.load()
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
data = native.bgzf_read_all(sys.argv[1])
arr = np.frombuffer(data, dtype=np.uint8)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps({"kib": after - before, "size": len(data),
                  "sum": int(arr[::4096].sum())}))
"""


def test_peak_is_under_1_3x_the_inflated_size(tmp_path):
    """~100 MB (a random 8 KiB block repeated, one byte in 997 changed:
    it deflates to ~20%, about what a BAM of HiFi reads does) written by
    the native deflater and inflated in a fresh process: ru_maxrss grows
    by less than 1.3x the inflated size (the JAX copy's grows by 2.0x; the
    C inflater holds the compressed file beside its output)."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 256, 1 << 13, dtype=np.uint8)
    data = np.tile(unit, 100 << 7)
    data[::997] = rng.integers(0, 256, len(data[::997]), dtype=np.uint8)
    path = str(tmp_path / "big.bgzf")
    assert native.bgzf_write_all(path, data, n_threads=4)
    assert os.path.getsize(path) < 0.2 * len(data)
    out = subprocess.run([sys.executable, "-c", PEAK_CHILD, path],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["size"] == len(data)
    assert rec["sum"] == int(data[::4096].sum())
    assert rec["kib"] * 1024 < 1.3 * len(data), rec
