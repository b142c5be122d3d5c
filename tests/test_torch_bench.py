"""The port's benchmark scripts, ``bench_torch.py`` and
``bench_search_torch.py``, against the JAX package on the CPU.

On CPU tensors every wrapper runs its plain PyTorch version, so these
tests hold the scripts' own inputs and calls against the JAX functions at
small sizes: the fused PDQ hash against ``pdq_hash_batch_jit`` at the JAX
suite's CPU tolerance (XLA-CPU contracts some multiply-add pairs into
FMAs: quality within 1, Hamming distance at most 4 where quality >= 31;
as ``tests/test_torch_pdq.py``), the 8-frame tile against
``similarity_segments_xla`` and the mean-71 sweep against
``make_exists_mask_kernel_xla`` exactly (integer outputs). The scripts'
entry points must refuse to run without CUDA unless told ``--device cpu``,
and then print a line whose times and rates are null. The kernels
themselves are timed and held against their plain versions on the card
(``chip_smoke.py`` phase 13 runs ``bench_torch.py`` there).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_search_torch as bs
import bench_torch
from hydrus_video_deduplicator_tpu.models import pdq as jax_pdq
from hydrus_video_deduplicator_tpu.ops import reps as jax_reps
from hydrus_video_deduplicator_tpu.ops import similarity_segments as jseg
from hydrus_video_deduplicator_tpu.vpdq import pdq_math as pm
from hydrus_video_deduplicator_tpu_torch.models import pdq

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
#: the keys of bench_torch.py's line, and each measurement's time keys
LINE_KEYS = {
    "metric", "value", "unit", "vs_baseline", "search_projected_1m_videos_sec",
    "search_vs_60s_target", "search_projected_1m_mean71_sec", "search_mean71_vs_60s_target",
    "measurements", "device", "launches",
}
TIME_KEYS = ("median_ms", "min_ms", "max_ms", "host_ms")


def hamming(a: bytes, b: bytes) -> int:
    return bin(int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).count("1")


def pm1(words: torch.Tensor, slots: torch.Tensor):
    """The JAX kernels' ±1 rows of the port's int32 words, expanded by the
    JAX module's own unpack_blocks_pm1 (as bench_search.py expands them)."""
    slots = jnp.asarray(slots.numpy())
    return jseg.unpack_blocks_pm1(jnp.asarray(words.numpy().view(np.uint32)), slots), slots


def test_pdq_measurement_equals_the_jax_hash():
    frames = np.random.default_rng(3).integers(0, 256, (4, 3, 512, 512), dtype=np.uint8)
    result, words, quality = bench_torch.measure_pdq(torch.from_numpy(frames))
    jwords, jquality = jax_pdq.pdq_hash_batch_jit(jnp.asarray(frames.transpose(0, 2, 3, 1)))
    got = pdq.words_to_blobs(words.numpy())
    want = jax_pdq.words_to_blobs(np.asarray(jwords))
    for i in range(len(frames)):
        assert abs(int(quality[i]) - int(jquality[i])) <= 1, f"frame {i}: quality drift"
        if int(jquality[i]) >= pm.QUALITY_MIN_KEEP:
            assert hamming(got[i], want[i]) <= 4, f"frame {i}: drifted too far"
    for name in ("hash", "filter"):
        assert result[name]["frames"] == 4 and result[name]["frames_per_s"] is None
        assert all(result[name][k] is None for k in TIME_KEYS)
    assert result["hash"]["checksum"] == int(words.sum()) + int(quality.sum())


def test_packing_equals_the_jax_packer():
    """packed_videos lays videos out as the JAX package's pack_blocks and
    stack_blocks, which bench_search.py packs its tile with."""
    rng = np.random.default_rng(4)
    for n_videos, frames, slots, multiple in (
        (300, jseg.ROW_FRAMES, jseg.ROW_SLOTS, 1),
        (70, jseg.CHUNK_FRAMES, jseg.CHUNK_SLOTS, jseg.N_SPLIT),
    ):
        words, slot_ids, counts = bs.packed_videos(rng, n_videos, frames, slots, multiple)
        items = [(v, words[v * bs.PAD : (v + 1) * bs.PAD].tobytes()) for v in range(n_videos)]
        blocks = jseg.pack_blocks(items, frames, slots)
        n_blocks = len(words) // frames
        assert len(blocks) <= n_blocks and n_blocks % multiple == 0
        want_words, want_slots, want_counts, _ = jseg.stack_blocks(blocks, n_blocks, frames, slots)
        assert np.array_equal(words, want_words)
        assert np.array_equal(slot_ids, want_slots)
        assert np.array_equal(counts, want_counts[:, 0])


def test_tile_equals_the_jax_similarity_segments_xla():
    operands = bs.tile_operands(CPU, 4, 8)
    result, out = bs.run_tile(operands, iters=1)
    a_words, slot_a, counts_a, b_words, slot_b, counts_b, _ = operands
    a, sa = pm1(a_words, slot_a)
    b, sb = pm1(b_words, slot_b)
    want = jseg.similarity_segments_xla(
        a, sa, jnp.asarray(counts_a.numpy()[:, None]), b, sb, jnp.asarray(counts_b.numpy()[:, None])
    )
    assert np.array_equal(out.numpy(), np.asarray(want))
    # the one plant (column video 0 is row video 0, 8 bits a frame away)
    assert int(out[0, 0]) == 100 and result["checksum"] == 100
    assert result["video_pairs"] == 32 and result["frame_comparisons"] == 32 * 64
    assert result["checked_steps"] == 1 and result["video_pairs_per_s"] is None


def test_sweep_equals_the_jax_exists_mask_kernel_xla():
    """One row block against one column tile at the pruned route's
    tolerance."""
    tol = jax_reps.prune_tolerance()
    operands = bs.sweep_operands(CPU, 1, bs.TILE_COL_STEPS)
    result, masks = bs.run_sweep(operands, tol, iters=1)
    a_words, slot_a, b_words, slot_b, _ = operands
    a, sa = pm1(a_words, slot_a)
    b, sb = pm1(b_words, slot_b)
    want = jseg.make_exists_mask_kernel_xla(tol)(a, sa, None, b, sb, None)
    assert np.array_equal(masks.numpy().view(np.uint32), np.asarray(want))
    n_plants = bs.TILE_COL_STEPS * jseg.STEP_SLOTS // bs.PLANT_STRIDE
    assert result["checksum"] >= n_plants >= 1 and result["tolerance"] == tol == 79
    assert result["frame_comparisons"] == jseg.ROW_FRAMES * bs.TILE_COL_STEPS * jseg.STEP_FRAMES


@pytest.mark.parametrize("module", [bench_torch, bs], ids=["bench_torch", "bench_search_torch"])
def test_main_without_cuda_exits_nonzero_and_measures_nothing(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = bench_torch.launches()
    with pytest.raises(SystemExit) as exc:
        module.main([])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr()
    assert out.out == "" and "CUDA is not available" in out.err
    assert bench_torch.launches() == before


@pytest.mark.parametrize("script", ["bench_torch.py", "bench_search_torch.py"])
def test_script_without_cuda_exits_nonzero(script):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 1 and proc.stdout == ""
    assert "nothing was measured" in proc.stderr


def test_main_on_the_cpu_prints_a_line_without_times(capsys):
    assert bench_torch.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == LINE_KEYS
    assert line["metric"] == "pdq_hash_frames_per_sec_per_chip" and line["unit"] == "frames/s"
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 0
    assert line["launches"] == {"pdq_filter": 0, "similarity_segments": 0, "exists_mask_sweep": 0}
    for key in ("value", "vs_baseline", "search_projected_1m_videos_sec", "search_vs_60s_target",
                "search_projected_1m_mean71_sec", "search_mean71_vs_60s_target"):
        assert line[key] is None, key
    m = line["measurements"]
    assert set(m) == {
        "pdq_hash_fused", "pdq_filter_kernel", "search_tile", "search_row_tile", "mean71_sweep"
    }
    for name, entry in m.items():
        assert all(entry[k] is None for k in TIME_KEYS), name
        assert all(entry[k] is None for k in entry if k.endswith("_per_s")), name
        assert entry["bytes"] > 0 and isinstance(entry["checksum"], int), name
    assert m["pdq_hash_fused"]["frames"] == bench_torch.CPU_BATCH
    assert m["search_tile"]["checksum"] == m["search_row_tile"]["checksum"] == 100
    assert m["mean71_sweep"]["checksum"] >= 1


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_measurements_on_the_card(cuda_device):
    """Each measurement at a small size on the card: its kernel launched,
    equal to its plain version (checked inside), and timed."""
    before = bench_torch.launches()
    result, _, _ = bench_torch.measure_pdq(bench_torch.make_frames(cuda_device, 8, 0))
    search = bs.measure(cuda_device, tr=4, tc=8, tc_wide=2048)
    mean71 = bs.measure_mean71(cuda_device, row_blocks=1, col_tiles=1)
    launched = {k: n - before[k] for k, n in bench_torch.launches().items()}
    assert all(n > 0 for n in launched.values()), launched
    for entry in (result["hash"], result["filter"], search["tile"], search["row_tile"],
                  mean71["sweep"]):
        assert 0 < entry["min_ms"] <= entry["median_ms"] <= entry["max_ms"]
    assert search["projected_1m_sec"] > 0 and mean71["projected_1m_sec"] > 0
