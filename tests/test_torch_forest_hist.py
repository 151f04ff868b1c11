# The port's node histograms (spark_rapids_ml_tpu_torch/ops/forest_hist.py,
# kernels B3 and B4) against the JAX package's: its Pallas kernels in
# interpret mode and its numpy oracle, on the same numpy inputs.  Integer
# stats (bootstrap counts x one-hot classes) give exact sums in any order,
# so those comparisons are exact; float stats are held to the JAX suite's
# bf16 tolerance (rtol 2e-2, atol 1e-3: the kernels round each stat to bf16).
# Here on the CPU the wrappers take their plain PyTorch versions;
# chip_smoke.py holds the CUDA kernel against them on the card.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import forest_hist as ref
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.ops.forest_hist import (
    ATOMIC_SMEM_BUDGET,
    _atomic_geometry,
    gather_rows,
    node_histograms,
    node_histograms_atomic,
    node_histograms_bucketed,
    node_histograms_mma,
    node_histograms_reference,
)

N, F_PAD, B = 2 * 2048, 32, 16
T, NODES, S = 3, 4, 2
NB, CAP, LOCAL = 4, 512, 4
BF16_RTOL, BF16_ATOL = 2e-2, 1e-3


def _inputs(seed, integer):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (F_PAD, N)).astype(np.int8)
    node = rng.integers(0, NODES + 2, (T, N)).astype(np.int32)  # ids >= NODES are masked
    if integer:
        counts = rng.poisson(1.0, (T, N)).astype(np.float32)
        y = rng.integers(0, S, N)
        stats = np.concatenate([counts[t][None] * (y[None] == np.arange(S)[:, None]) for t in range(T)])
    else:
        stats = rng.random((T * S, N)).astype(np.float32)  # the JAX suite's float stats
    return bins, node, stats.astype(np.float32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module", params=["integer", "float"])
def shallow(request):
    bins, node, stats = _inputs(1, request.param == "integer")
    H_ref = np.asarray(
        ref.node_histograms(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats),
            t_pack=T, nodes=NODES, s_dim=S, n_bins=B, interpret=True,
        )
    )
    return request.param, bins, node, stats, H_ref


def test_node_histograms_match_jax_kernel(shallow):
    kind, bins, node, stats, H_ref = shallow
    H = node_histograms(*_torch(bins, node, stats), t_pack=T, nodes=NODES, s_dim=S, n_bins=B).numpy()
    assert H.shape == (F_PAD, 128, B) and H.dtype == np.float32
    if kind == "integer":
        np.testing.assert_array_equal(H, H_ref)
    else:
        np.testing.assert_allclose(H, H_ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_node_histograms_match_oracles(shallow):
    kind, bins, node, stats, _ = shallow
    sl = slice(0, 512)  # the oracles loop row by row
    b, n, s = (np.ascontiguousarray(a[:, sl]) for a in (bins, node, stats))
    H = node_histograms(*_torch(b, n, s), t_pack=T, nodes=NODES, s_dim=S, n_bins=B).numpy()
    H_np = ref.node_histograms_reference(b, n, s, T, NODES, S, B)
    H_bf16 = node_histograms_reference(*_torch(b, n, s), T, NODES, S, B).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(H, H_np)
        np.testing.assert_array_equal(H, H_bf16)
    else:
        np.testing.assert_allclose(H, H_np, rtol=BF16_RTOL, atol=BF16_ATOL)
        # the same bf16-rounded terms, summed in another order
        np.testing.assert_allclose(H, H_bf16, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=["integer", "float"])
def bucketed(request):
    rng = np.random.default_rng(2)
    n = NB * CAP
    bins = rng.integers(0, B, (F_PAD, n)).astype(np.int8)
    node = rng.integers(0, LOCAL + 1, (1, n)).astype(np.int32)
    node[0, rng.random(n) < 0.05] = 1 << 18  # the deep phase's stray rows
    if request.param == "integer":
        w = rng.poisson(1.0, n).astype(np.float32)
        y = rng.integers(0, S, n)
        stats = (w[None] * (y[None] == np.arange(S)[:, None])).astype(np.float32)
    else:
        stats = rng.random((S, n)).astype(np.float32)
    H_ref = np.asarray(
        ref.node_histograms_bucketed(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats),
            n_buckets=NB, nodes=LOCAL, s_dim=S, n_bins=B, interpret=True,
        )
    )
    return request.param, bins, node, stats, H_ref


def test_node_histograms_bucketed_match_jax_kernel(bucketed):
    kind, bins, node, stats, H_ref = bucketed
    H = node_histograms_bucketed(*_torch(bins, node, stats), n_buckets=NB, nodes=LOCAL, s_dim=S, n_bins=B).numpy()
    assert H.shape == H_ref.shape == (NB, F_PAD, 8, B)
    if kind == "integer":
        np.testing.assert_array_equal(H, H_ref)
    else:
        np.testing.assert_allclose(H, H_ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_node_histograms_bucketed_are_per_bucket_histograms(bucketed):
    kind, bins, node, stats, _ = bucketed
    H = node_histograms_bucketed(*_torch(bins, node, stats), n_buckets=NB, nodes=LOCAL, s_dim=S, n_bins=B)
    for b in range(NB):
        sl = slice(b * CAP, (b + 1) * CAP)
        one = node_histograms(
            *_torch(bins[:, sl], node[:, sl], stats[:, sl]), t_pack=1, nodes=LOCAL, s_dim=S, n_bins=B
        )
        if kind == "integer":
            torch.testing.assert_close(H[b], one[:, :8], rtol=0, atol=0)
        else:
            torch.testing.assert_close(H[b], one[:, :8], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("nodes,s_dim", [(3, 3), (5, 1), (7, 2)])
def test_node_histograms_bucketed_padded_slots_and_strays_match_jax_kernel(kind, nodes, s_dim):
    """nodes * s_dim not a multiple of 8: the slots past it are padding and
    must read 0 (the card kernel writes every cell of its output itself).
    Stray node ids (negative, == nodes, the deep phase's 1 << 18) and stray
    bins (negative, >= B) add nothing."""
    rng = np.random.default_rng(nodes * 10 + s_dim)
    nb, cap = 3, 1024
    n = nb * cap
    bins = rng.integers(0, B, (F_PAD, n)).astype(np.int8)
    bins[rng.random((F_PAD, n)) < 0.05] = -1
    bins[rng.random((F_PAD, n)) < 0.05] = B + 3
    node = rng.integers(0, nodes + 1, (1, n)).astype(np.int32)
    node[0, rng.random(n) < 0.05] = 1 << 18
    node[0, rng.random(n) < 0.05] = -2
    if kind == "integer":
        w = rng.poisson(1.0, n).astype(np.float32)
        y = rng.integers(0, s_dim, n)
        stats = (w[None] * (y[None] == np.arange(s_dim)[:, None])).astype(np.float32)
    else:
        stats = rng.random((s_dim, n)).astype(np.float32)
    H_ref = np.asarray(
        ref.node_histograms_bucketed(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats),
            n_buckets=nb, nodes=nodes, s_dim=s_dim, n_bins=B, interpret=True,
        )
    )
    H = node_histograms_bucketed(*_torch(bins, node, stats), n_buckets=nb, nodes=nodes, s_dim=s_dim, n_bins=B)
    slots_pad = -(-(nodes * s_dim) // 8) * 8
    assert tuple(H.shape) == H_ref.shape == (nb, F_PAD, slots_pad, B)
    assert not H[:, :, nodes * s_dim :].any() and not H_ref[:, :, nodes * s_dim :].any()
    if kind == "integer":
        np.testing.assert_array_equal(H.numpy(), H_ref)
        # the integer-stats declaration (the card's int32 cells) changes no bit
        H_int = node_histograms_bucketed(
            *_torch(bins, node, stats), n_buckets=nb, nodes=nodes, s_dim=s_dim, n_bins=B, integer_stats=True
        )
        np.testing.assert_array_equal(H_int.numpy(), H_ref)
    else:
        np.testing.assert_allclose(H.numpy(), H_ref, rtol=BF16_RTOL, atol=BF16_ATOL)


# (f_pad, n_buckets, rows a bucket, slots, bins): the deep windows
# chip_smoke.py times (one split: each block owns its slice), the
# classifier's atomic-route levels 4-6 and the regressor's levels 4-5 (one
# bucket of 1,001,472 rows: split), a small deep launch, and ragged ones
GEOMETRY_CASES = [
    (64, 128, 8192, 64, 128), (64, 128, 8192, 2, 128), (64, 2, 16384, 15, 128), (64, 1, 1_001_472, 128, 128), (1024, 1, 1_001_472, 128, 128),
    (64, 7, 512, 8, 128), (32, 3, 1024, 9, 16), (5, 1, 3001, 1, 7), (1024, 65535, 512, 2, 2),
]


@pytest.mark.parametrize("f_pad,n_buckets,seg_len,slots,n_bins", GEOMETRY_CASES, ids=str)
def test_atomic_geometry_covers_every_bucket_feature_and_row_once(f_pad, n_buckets, seg_len, slots, n_bins):
    """Block (f, s, z) of the atomic kernel takes features [f*fb, +fb) and
    rows [s*rows, +rows) of bucket z, clipped: every (bucket, feature, row)
    lies in exactly one block, no block is empty, and a block's histograms
    fit its shared-memory budget (one feature at least)."""
    fb, splits, rows = _atomic_geometry(f_pad, n_buckets, seg_len, slots, n_bins)
    f_groups = -(-f_pad // fb)
    feat_hits = np.zeros(f_pad, np.int64)
    for f in range(f_groups):
        lo, hi = f * fb, min(f * fb + fb, f_pad)
        assert hi > lo
        feat_hits[lo:hi] += 1
    row_hits = np.zeros(seg_len, np.int64)
    for sp in range(splits):
        lo, hi = sp * rows, min(sp * rows + rows, seg_len)
        assert hi > lo
        row_hits[lo:hi] += 1
    assert (feat_hits == 1).all() and (row_hits == 1).all()
    assert rows % 4 == 0  # the kernel's aligned 4-row loads
    assert fb == 1 or 4 * fb * slots * n_bins <= ATOMIC_SMEM_BUDGET
    assert 1 <= splits <= 65535


def test_atomic_geometry_owner_flush_where_the_main_path_needs_it():
    # B4 at a deep window of 128 buckets, at every deep level (1 to 32 local
    # nodes): the features are cut before the rows, so there is one split
    # and every block writes its own slice
    for nodes in (1, 2, 4, 8, 16, 32):
        fb, splits, rows = _atomic_geometry(64, 128, 8192, nodes * 2, 128)
        assert splits == 1 and rows == 8192 and -(-64 // fb) * 128 >= 1024
    # B3's atomic route at the classifier's levels 4-6: rows split, atomics
    for t_pack, nodes in ((4, 16), (2, 32), (1, 64)):
        assert _atomic_geometry(64, 1, 1_001_472, t_pack * nodes * 2, 128)[1] > 1


def test_gather_rows_matches_jax_gather():
    rng = np.random.default_rng(0)
    bins = rng.integers(0, 128, (23, 2 * 2048)).astype(np.int8)
    feats = rng.choice(23, 7, replace=False).astype(np.int32)
    want = np.asarray(ref.gather_rows_matmul(jnp.asarray(bins), jnp.asarray(feats), f_pad=32, chunk=2048))
    np.testing.assert_array_equal(gather_rows(torch.from_numpy(bins), torch.from_numpy(feats), 32).numpy(), want)


def test_out_of_range_bins_and_nodes_add_nothing():
    bins = torch.tensor([[0, 3, -1, 127]], dtype=torch.int8)
    node = torch.tensor([[0, 1, 0, -5]], dtype=torch.int32)
    stats = torch.tensor([[1.0, 2.0, 4.0, 8.0]])
    H = node_histograms(bins, node, stats, t_pack=1, nodes=2, s_dim=1, n_bins=4)
    assert float(H.sum()) == 3.0 and float(H[0, 0, 0]) == 1.0 and float(H[0, 1, 3]) == 2.0


def test_stats_are_rounded_to_bf16():
    x = 1.0 + 2.0**-9  # not a bf16 value: rounds to 1.0 (nearest even)
    H = node_histograms(
        torch.zeros((1, 4), dtype=torch.int8), torch.zeros((1, 4), dtype=torch.int32),
        torch.full((1, 4), x), t_pack=1, nodes=1, s_dim=1, n_bins=2,
    )
    assert float(H[0, 0, 0]) == 4.0


def test_cpu_tensors_never_touch_the_kernel(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail(f"kernel library {name} loaded"))
    routes = (node_histograms_mma, node_histograms_atomic, node_histograms_bucketed)
    for fn in routes:
        monkeypatch.setattr(fn, "launches", 0)
    bins, node, stats = _inputs(3, True)
    shallow = _torch(bins[:, :512], node[:, :512], stats[:, :512])
    for fn in (node_histograms, node_histograms_mma, node_histograms_atomic):
        fn(*shallow, t_pack=T, nodes=NODES, s_dim=S, n_bins=B)
    node_histograms_bucketed(
        *_torch(bins[:, :1024], node[:1, :1024], stats[:S, :1024]), n_buckets=2, nodes=NODES, s_dim=S, n_bins=B
    )
    assert all(fn.launches == 0 for fn in routes)


def test_other_devices_raise():
    bins = torch.zeros((1, 4), dtype=torch.int8, device="meta")
    node = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    stats = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        node_histograms(bins, node, stats, t_pack=1, nodes=1, s_dim=1, n_bins=2)


@pytest.mark.parametrize(
    "case,error",
    [
        ("bins_int32", TypeError),
        ("stats_f64", TypeError),
        ("too_many_slots", ValueError),
        ("too_many_bins", ValueError),
        ("row_mismatch", ValueError),
        ("pack_mismatch", ValueError),
        ("non_contiguous", ValueError),
        ("ragged_buckets", ValueError),
    ],
)
def test_wrappers_reject_bad_inputs(monkeypatch, case, error):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("reached the launch"))
    bins = torch.zeros((32, 1024), dtype=torch.int8)
    node = torch.zeros((2, 1024), dtype=torch.int32)
    stats = torch.zeros((4, 1024))
    kw = dict(t_pack=2, nodes=4, s_dim=2, n_bins=16)
    call = node_histograms
    if case == "bins_int32":
        bins = bins.int()
    elif case == "stats_f64":
        stats = stats.double()
    elif case == "too_many_slots":
        kw["nodes"] = 64
    elif case == "too_many_bins":
        kw["n_bins"] = 129
    elif case == "row_mismatch":
        stats = torch.zeros((4, 1000))
    elif case == "pack_mismatch":
        node = torch.zeros((3, 1024), dtype=torch.int32)
    elif case == "non_contiguous":
        bins = torch.zeros((1024, 32), dtype=torch.int8).T
    elif case == "ragged_buckets":
        call, node, stats = node_histograms_bucketed, node[:1], stats[:2]
        kw = dict(n_buckets=3, nodes=4, s_dim=2, n_bins=16)
    with pytest.raises(error):
        call(bins, node, stats, **kw)
