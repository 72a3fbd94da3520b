"""The wide tables' host packing and upload in bounded memory: pack_text2
(the 2-bit span rows and badrow bits of the forward text) packed a chunk
of rows at a time, byte for byte the JAX package's pack_text2, at a traced
peak of at most 3 B a symbol; and build_device_anchor_wide's chunked
uploads (_put_words, fused_counts) equal to one-piece ones and to the
JAX package's tables."""

import tracemalloc

import numpy as np
import pytest
import torch

from svdss_tpu.ops import anchor_wide_jax as jw
from svdss_tpu.ops.anchor_wide import \
    build_anchor_index_wide as j_build_anchor_index_wide
from svdss_tpu_torch.ops import anchor_wide_device as aw
from svdss_tpu_torch.ops.anchor_wide import build_anchor_index_wide

torch.set_num_threads(1)


def text_with_runs(rng, n, run_at=()):
    """ACGT text with runs of N (5) and separators (0) starting at
    `run_at` (each 300 symbols, so a run spans a chunk edge)."""
    t = rng.integers(1, 5, n).astype(np.uint8)
    for a in run_at:
        t[a:a + 300] = 5
        t[min(n - 1, a + 150)] = 0
    return t


# sizes around the 256-symbol row stride and chunks of 3 rows (768
# symbols): partial last rows and partial last chunks, runs of non-ACGT
# symbols across chunk edges
SIZES = [(0, ()), (1, ()), (255, ()), (256, ()), (257, (10,)),
         (511, ()), (768 * 4, (600, 1500)), (768 * 4 + 1, (760,)),
         (768 * 5 + 300, (2200, 3500)), (100_003, (700, 45_000, 99_900))]


@pytest.mark.parametrize("n,runs", SIZES, ids=[str(n) for n, _ in SIZES])
@pytest.mark.parametrize("rows", [3, aw.PACK_ROWS])
def test_pack_text2_bytes_equal_jax(n, runs, rows):
    rng = np.random.default_rng(n + 7)
    text = text_with_runs(rng, n, runs)
    got_w, got_b = aw.pack_text2(text, rows=rows)
    want_w, want_b = jw.pack_text2(text)
    assert got_w.dtype == want_w.dtype == np.int32
    assert got_b.dtype == want_b.dtype == np.int32
    assert got_w.shape == want_w.shape and got_b.shape == want_b.shape
    assert got_w.tobytes() == want_w.tobytes()
    assert got_b.tobytes() == want_b.tobytes()


def test_pack_text2_traced_peak():
    """At n = 2^24 the packing's traced peak is at most 3 B a symbol (the
    output alone is 0.5; the one-piece packing it replaces peaked at 18)."""
    n = 1 << 24
    text = np.random.default_rng(3).integers(0, 6, n).astype(np.uint8)
    tracemalloc.start()
    try:
        words, bad = aw.pack_text2(text)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert words.shape == (n // 256 + 1, 32)
    assert peak <= 3 * n, peak / n


@pytest.mark.parametrize("raw", [0, 1, 2, 3, 5, 8, 33])
def test_put_words_chunks(monkeypatch, raw):
    """Raw bytes to int32 words: any chunk size gives the words of the
    zero-padded bytes, uint8 / uint16 / uint32 alike."""
    rng = np.random.default_rng(raw)
    for dtype in (np.uint8, np.uint16, np.uint32):
        a = rng.integers(0, np.iinfo(dtype).max, raw, dtype=dtype,
                         endpoint=True)
        b = a.view(np.uint8)
        b = np.concatenate([b, np.zeros(-len(b) % 4, np.uint8)])
        want = b.view(np.int32)
        for chunk in (1, 2, 1 << 26):
            monkeypatch.setattr(aw, "UPLOAD_WORDS", chunk)
            got = aw._put_words(a, torch.device("cpu"))
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), (dtype, chunk)
            got = aw._put_words(a, torch.device("cpu"), len(want) + 3)
            assert np.array_equal(got.numpy()[:len(want)], want)
            assert not got.numpy()[len(want):].any()


@pytest.mark.parametrize("build", [dict(k=8, cmax=44),
                                   dict(k=8, cmax=300),
                                   dict(k=8, cmax=44, sort_buckets="right")],
                         ids=["ct16", "ct32_l16", "right_only"])
def test_chunked_tables_equal_jax(monkeypatch, build):
    """build_device_anchor_wide with uploads and count fusing in small
    chunks: every table equals the JAX package's, word for word."""
    rng = np.random.default_rng(11)
    text = rng.integers(1, 5, 60_001).astype(np.uint8)
    text[20_000:20_400] = 5
    text[40_000] = 0
    text[50_000:53_000] = text[10_000:13_000]      # a repeat: buckets > 1
    monkeypatch.setattr(aw, "UPLOAD_WORDS", 1000)
    monkeypatch.setattr(aw, "CT_KEYS", 512)
    dev, params = aw.build_device_anchor_wide(
        build_anchor_index_wide(text.copy(), **build), "cpu")
    jdev, jparams = jw.build_device_anchor_wide(
        j_build_anchor_index_wide(text.copy(), **build))
    for f in aw.DeviceAnchorWide._fields:
        g = getattr(dev, f).numpy()
        w = np.asarray(getattr(jdev, f))
        assert g.shape == w.shape, f
        assert g.tobytes() == w.astype(g.dtype).tobytes(), f
    assert (params.k, params.j0, params.cmax, params.n, params.bm_bases) \
        == (jparams.k, jparams.j0, jparams.cmax, jparams.n,
            tuple(jparams.bm_bases))


def test_device_tables_traced_peak():
    """build_device_anchor_wide holds no second host copy of a table: over
    a 2^24-symbol text (16.7M poslist entries) the numpy memory it traces
    stays within 3 B a symbol (the one-piece packing and the uint32 copy
    of the poslist it replaces took ~22)."""
    n = 1 << 24
    text = np.random.default_rng(5).integers(1, 5, n).astype(np.uint8)
    widx = build_anchor_index_wide(text, k=10, cmax=60)
    assert len(widx.poslist) > n // 2
    tracemalloc.start()
    try:
        dev, _ = aw.build_device_anchor_wide(widx, "cpu")
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert dev.pospairs.numel() >= len(widx.poslist)
    assert peak <= 3 * n, peak / n
