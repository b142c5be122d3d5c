"""The port's multi-device path (``parallel.mesh``, the row-sharded engine,
the sharded hasher, the orchestrator's mesh and the dry run) on the CPU,
against the port on one device and the JAX package on the suite's 8
virtual CPU devices (``tests/conftest.py``).

The port's mesh is 8 ``cpu`` members, a flat list, held against JAX's 1-D
mesh and its (2, 4) ("dcn", "ici") mesh, which shards rows over both axes
jointly: every member runs its slab through the kernels' plain versions.
Every result is an integer or a byte, so every comparison is exact.
"""

from __future__ import annotations

import threading
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

from hydrus_video_deduplicator_tpu.models.vpdq import TpuVideoHasher
from hydrus_video_deduplicator_tpu.parallel.engine import TpuSearchEngine
from hydrus_video_deduplicator_tpu_torch import dedup
from hydrus_video_deduplicator_tpu_torch.models import vpdq as mvpdq
from hydrus_video_deduplicator_tpu_torch.models.vpdq import GpuVideoHasher
from hydrus_video_deduplicator_tpu_torch.ops import _build
from hydrus_video_deduplicator_tpu_torch.ops import similarity_block as sb
from hydrus_video_deduplicator_tpu_torch.ops import similarity_segments as seg
from hydrus_video_deduplicator_tpu_torch.parallel import dryrun
from hydrus_video_deduplicator_tpu_torch.parallel import mesh as mesh_mod
from hydrus_video_deduplicator_tpu_torch.parallel.engine import CorpusIndex, GpuSearchEngine
from hydrus_video_deduplicator_tpu_torch.parallel.mesh import Mesh, row_slabs

from .fake_hydrus import FakeHydrus
from .test_torch_hasher import _items
from .unit_tests.test_pruned_search import _reencode, _scene_video

LAYOUTS = {"1-D": ((8,), ("d",)), "2-D": ((2, 4), ("dcn", "ici"))}


def _port_mesh(device: str = "cpu") -> Mesh:
    return Mesh([device] * 8)


@pytest.fixture(scope="module")
def jax_meshes():
    devices = np.asarray(jax.devices())
    assert devices.size == 8, "tests/conftest.py sets 8 virtual CPU devices"
    return {name: JaxMesh(devices.reshape(shape), axes) for name, (shape, axes) in LAYOUTS.items()}


def _corpus(rng, long_video: bool) -> list[bytes]:
    """Scene videos of 3-8 frames (two buckets, so the JAX engine compiles
    few tiles), a re-encode, a 3-frame subset clip and an empty hash; with
    long_video, a 600-frame video and its re-encode."""
    vids = [_scene_video(rng, int(rng.integers(1, 3)), int(rng.integers(3, 5))) for _ in range(24)]
    vids.append(_reencode(rng, vids[3]))
    vids.append(_reencode(rng, vids[7])[:3])
    vids.append(np.zeros((0, 32), dtype=np.uint8))
    if long_video:
        vids.append(_scene_video(rng, 60, 10))
        vids.append(_reencode(rng, vids[-1]))
    return [v.tobytes() for v in vids]


@pytest.fixture(scope="module")
def corpora(jax_meshes):
    """The short corpus (the segment route) and the long one (the bucketed
    route and the pruned search's complements), each with the JAX engine's
    all-pairs result at min_sim 1 on its 1-D and its 2-D mesh."""
    rng = np.random.default_rng(808)
    out = {}
    for name, long_video in (("short", False), ("long", True)):
        blobs = _corpus(rng, long_video)
        out[name] = blobs, {
            layout: sorted(TpuSearchEngine(mesh=jm).find_pairs(blobs, blobs, 1))
            for layout, jm in jax_meshes.items()
        }
    return out


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("n_rows", [0, 3, 8, 13, 24])
def test_row_slabs_are_the_jax_partition(jax_meshes, layout, n_rows):
    """JAX shards only multiples of the mesh size: the rows pad up to one,
    and each member's slab is the shard of the JAX device at its place in
    the row-major order, cut back to the real rows."""
    jm = jax_meshes[layout]
    padded = -(-n_rows // 8) * 8
    arr = jax.device_put(
        np.zeros((padded, 1)), NamedSharding(jm, PartitionSpec(tuple(jm.axis_names)))
    )
    shard = {s.device: s.index[0].indices(padded) for s in arr.addressable_shards}
    want = [(min(shard[d][0], n_rows), min(shard[d][1], n_rows)) for d in jm.devices.flat]
    assert row_slabs(n_rows, _port_mesh()) == want


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("corpus", ["short", "long"])
def test_find_pairs_on_the_mesh_equals_one_device_and_jax(corpora, layout, corpus):
    """The segment route (videos of at most 512 frames), the bucketed
    route (a 600-frame side) and the host path, row-sharded: the same
    sorted (row, col, similarity) as the port on one device and the JAX
    engine on its 1-D or 2-D mesh."""
    blobs, brute = corpora[corpus]
    got = sorted(GpuSearchEngine(mesh=_port_mesh()).find_pairs(blobs, blobs, 1))
    assert got == brute[layout]
    assert got == sorted(GpuSearchEngine(device="cpu").find_pairs(blobs, blobs, 1))
    assert any(i != j for i, j, _ in got)  # the planted pairs, not only self-pairs


def test_find_pairs_pruned_on_the_mesh_in_triangle_chunks(corpora):
    """The pruned search (stage A sharded, stage B on the first member, the
    long-video complements sharded) in two checkpointed chunks with
    col_limit, a shared col_state and rows_at, as stage 4 runs it: the
    same pairs as the port on one device, and as the JAX all-pairs result
    restricted to the triangle."""
    blobs, brute = corpora["long"]
    n, half = len(blobs), len(blobs) // 2

    def chunked(engine):
        state: dict = {}
        got = engine.find_pairs_pruned(
            blobs[:half], blobs, 20, col_state=state, col_limit=half, rows_at=0
        )
        got += [
            (i + half, j, s)
            for i, j, s in engine.find_pairs_pruned(
                blobs[half:], blobs, 20, col_state=state, col_limit=n, rows_at=half
            )
        ]
        return sorted(got)

    got = chunked(GpuSearchEngine(mesh=_port_mesh()))
    assert got == chunked(GpuSearchEngine(device="cpu"))
    assert got == [h for h in brute["1-D"] if h[2] >= 20 and (h[0] >= half or h[1] < half)]
    pruned = GpuSearchEngine(mesh=_port_mesh()).find_pairs_pruned(blobs, blobs, 1)
    assert sorted(pruned) == brute["2-D"]


def test_segment_route_shards_padded_tiles_and_reports_progress_as_one_device(
    corpora, monkeypatch
):
    """One row block per member and tile: the rows' few row blocks round
    up to one tile of 8, one slab per member, the padding blocks matching
    nothing; the bucketed route splits its row tile into one slab per
    member; the pairs and the progress callback's totals are one
    device's."""
    blobs, _ = corpora["long"]
    rows = [b for b in blobs for _ in range(30)]
    launched = {"seg": [], "block": []}
    real_seg, real_block = seg.similarity_segments, sb.similarity_block

    def seg_counted(a_words, *args):
        launched["seg"].append(a_words.shape[0] // seg.ROW_FRAMES)
        return real_seg(a_words, *args)

    def block_counted(rows_words, rows_counts, cols_words, cols_counts, pa, pb):
        launched["block"].append((rows_words.shape[0], pa))
        return real_block(rows_words, rows_counts, cols_words, cols_counts, pa, pb)

    monkeypatch.setattr(seg, "similarity_segments", seg_counted)
    monkeypatch.setattr(sb, "similarity_block", block_counted)
    monkeypatch.setattr(GpuSearchEngine, "_row_blocks_per_tile", lambda self, n, s: 1)
    seen = {}
    for key, engine in (("mesh", GpuSearchEngine(mesh=_port_mesh())),
                        ("one", GpuSearchEngine(device="cpu"))):
        launched = {"seg": [], "block": []}
        events = []
        got = engine.find_pairs(rows, blobs, 75, progress=lambda d, t: events.append((d, t)))
        seen[key] = sorted(got), events[-1], launched
    assert seen["mesh"][:2] == seen["one"][:2]
    assert seen["mesh"][1][0] == seen["mesh"][1][1] > 0
    assert seen["mesh"][2]["seg"] == [1] * 8
    assert 1 < len(seen["one"][2]["seg"]) < 8 and set(seen["one"][2]["seg"]) == {1}
    # the 60 rows of the 600-frame videos against each column bucket: one
    # tile, in slabs of 8 but the last of 4
    n_buckets = len(CorpusIndex(blobs).buckets)
    long_rows = {k: [n for n, pa in seen[k][2]["block"] if pa == 1024] for k in seen}
    assert long_rows["mesh"] == ([8] * 7 + [4]) * n_buckets
    assert long_rows["one"] == [60] * n_buckets


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_hasher_bytes_equal_one_device_and_jax(jax_meshes, layout):
    """A batch split into one slab per member, with a partial last batch
    (and its empty slabs): byte-equal hashes."""
    items = _items()[:3]
    hasher = GpuVideoHasher(mesh=_port_mesh(), batch_size=12, decode_workers=2)
    assert hasher.batch_size == 16  # rounded up to a multiple of the mesh size
    got = hasher.hash_videos(items)
    one = GpuVideoHasher(device="cpu", batch_size=16).hash_videos(items)
    ref = TpuVideoHasher(mesh=jax_meshes[layout]).hash_videos(items)
    assert hasher.stats["frames"] % 16  # the last batch is partial
    for g, o, r in zip(got, one, ref):
        assert g.error is None and len(g.phash.bytes) > 0
        assert g.phash.bytes == o.phash.bytes == r.phash.bytes
        assert g.n_frames == o.n_frames == r.n_frames


def test_a_members_hash_failure_propagates_and_releases_the_decode_workers(monkeypatch):
    """The second member's slab fails: the error reaches the caller and no
    decode worker stays blocked on the bounded frame queue."""
    items = [(k, data) for k, data in _items()[:4]] * 3
    calls = {"n": 0}
    real = mvpdq.pdq_hash_batch_fused

    def failing(frames):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("member 1 fell over")
        return real(frames)

    monkeypatch.setattr(mvpdq, "pdq_hash_batch_fused", failing)
    hasher = GpuVideoHasher(mesh=_port_mesh(), batch_size=8, decode_workers=4)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="member 1 fell over"):
        hasher.hash_videos(items)
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "decode workers leaked"
    assert calls["n"] == 2


def test_the_orchestrator_builds_a_mesh_only_over_several_unnamed_devices(monkeypatch):
    """device=None and several CUDA devices visible: a 1-D mesh over all of
    them; a named device, or one visible device, means no mesh. The count
    is patched; no tensor goes to a CUDA device."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    built = dedup.HydrusVideoDeduplicator(None, None)._device_mesh()
    assert built.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert built.size == 4
    assert dedup.HydrusVideoDeduplicator(None, None, device="cpu")._device_mesh() is None
    assert dedup.HydrusVideoDeduplicator(None, None, device="cuda:1")._device_mesh() is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dedup.HydrusVideoDeduplicator(None, None)._device_mesh() is None


def test_dryrun_multidevice_on_four_cpu_members():
    summary = dryrun.dryrun_multidevice(Mesh(["cpu"] * 4), FakeHydrus)
    assert summary["7 marked pairs"] == 8 and summary["5 layout"] == repr(Mesh(["cpu"] * 8))


def test_a_mesh_refuses_to_mix_cpu_and_cuda_and_engines_a_device_beside_it():
    with pytest.raises(ValueError, match="mix CPU and CUDA"):
        Mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="index"):
        Mesh(["cuda", "cuda"])
    mesh = Mesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="not both"):
        GpuSearchEngine(device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        GpuVideoHasher(device="cpu", mesh=mesh)


def test_a_launch_refuses_an_input_on_another_device(monkeypatch):
    """The wrappers' device check, on meta tensors: it raises before any
    library is loaded."""
    monkeypatch.setattr(_build, "load_library", lambda name: pytest.fail("loaded a library"))
    out = torch.empty(4, device="meta")
    _build.check_same_device(out, a=torch.empty(2, device="meta"))
    with pytest.raises(ValueError, match="b is on cpu, the output on meta"):
        _build.check_same_device(out, a=torch.empty(2, device="meta"), b=torch.zeros(2))
    rows = torch.empty((2, 4, 8), dtype=torch.int32, device="meta")
    counts = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cols_words is on cpu"):
        sb._launch(rows, counts, torch.zeros((3, 4, 8), dtype=torch.int32), counts, 4, 4)


@pytest.fixture(params=["shared card", "one member per card"])
def cuda_mesh(request):
    """Four members on the first card, each with a stream of its own; or
    one member on each visible card, where there are several."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    if request.param == "shared card":
        return Mesh(["cuda:0"] * 4)
    if torch.cuda.device_count() < 2:
        pytest.skip("needs several CUDA devices")
    return mesh_mod.build_mesh()


@pytest.mark.cuda
def test_mesh_on_cuda_equals_one_device(corpora, cuda_mesh):
    """On the card, four members sharing it: the sweep, kernel 3 and kernel
    5 launch per member, and the pairs equal one device's and the JAX
    engine's; the mesh hasher's hashes equal one device's."""
    blobs, brute = corpora["long"]
    engine = GpuSearchEngine(mesh=cuda_mesh)
    before = dict(seg.LAUNCHES), dict(sb.LAUNCHES)
    assert sorted(engine.find_pairs(blobs, blobs, 1)) == brute["1-D"]
    assert sorted(engine.find_pairs_pruned(blobs, blobs, 1)) == brute["1-D"]
    assert seg.LAUNCHES["exists_mask_sweep"] - before[0]["exists_mask_sweep"] >= 4
    assert seg.LAUNCHES["similarity_segments"] - before[0]["similarity_segments"] >= 4
    assert sb.LAUNCHES["similarity_block"] > before[1]["similarity_block"]
    items = _items()
    got = GpuVideoHasher(mesh=cuda_mesh, batch_size=40).hash_videos(items)
    one = GpuVideoHasher(device="cuda:0", batch_size=40).hash_videos(items)
    assert [r.phash.bytes for r in got] == [r.phash.bytes for r in one]


@pytest.mark.cuda
def test_dryrun_multidevice_on_cuda(cuda_mesh):
    assert dryrun.dryrun_multidevice(cuda_mesh, FakeHydrus)["7 marked pairs"] == 8
