# The two routes of the port's shallow node histograms (kernel B3,
# spark_rapids_ml_tpu_torch/ops/forest_hist.py): the route function that
# picks the tensor-core kernel or the atomic kernel per launch, the
# tensor-core kernel's row split, and node_histograms_onehot_plain, the
# tensor-core route's arithmetic in plain PyTorch (bf16 one-hot of the bins
# times the bf16 masked stat tile, summed in fp32), held against
# node_histograms_plain and the JAX package's Pallas kernel in interpret
# mode on the same numpy inputs.  Integer stats (bootstrap counts x one-hot
# classes) give exact sums in any order, so those comparisons are exact;
# float stats are held to the JAX suite's bf16 tolerance (rtol 2e-2, atol
# 1e-3) against JAX, and to 1e-5 against the plain version, which adds the
# same bf16-rounded terms in another order.
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.ops import forest_hist as ref
from spark_rapids_ml_tpu_torch.ops import _build
from spark_rapids_ml_tpu_torch.ops.forest_grow import shallow_launches
from spark_rapids_ml_tpu_torch.ops.forest_hist import (
    MMA_ROWS_TILE,
    _hist_route,
    _mma_geometry,
    node_histograms,
    node_histograms_atomic,
    node_histograms_mma,
    node_histograms_onehot_plain,
    node_histograms_plain,
)

BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
# the flagship fits of the RandomForest benchmark: (F_pad, trees, maxDepth),
# classifier featureSubsetStrategy "sqrt" of 3000 (54 -> 64), regressor
# "onethird" (1000 -> 1024); two stat rows each, 128 bins
FLAGSHIPS = {"classifier": (64, 50, 13), "regressor": (1024, 30, 6)}
FLAGSHIP_N = 1_001_472  # 1,000,000 rows padded to 2048s
S, B = 2, 128


def _flagship_launches():
    cases = []
    for name, (f_pad, trees, depth) in FLAGSHIPS.items():
        for level, nodes, t_pack in dict.fromkeys(shallow_launches(trees, S, depth)):
            cases.append(pytest.param(f_pad, t_pack, nodes, level, id=f"{name}-l{level}-t{t_pack}"))
    return cases


@pytest.mark.parametrize("f_pad,t_pack,nodes,level", _flagship_launches())
def test_hist_route_is_total_and_deterministic(f_pad, t_pack, nodes, level):
    route = _hist_route(t_pack, nodes, S, B)
    assert route in ("mma", "atomic")
    assert all(_hist_route(t_pack, nodes, S, B) == route for _ in range(3))
    if level == 0:
        assert route == "mma"
    splits, per_split = _mma_geometry(f_pad, FLAGSHIP_N, B)
    tiles = -(-FLAGSHIP_N // MMA_ROWS_TILE)
    assert splits * per_split >= tiles > (splits - 1) * per_split


@pytest.mark.parametrize("name", FLAGSHIPS)
def test_hist_route_switches_once_with_depth(name):
    _, trees, depth = FLAGSHIPS[name]
    routes = [_hist_route(t_pack, nodes, S, B) for _, nodes, t_pack in shallow_launches(trees, S, depth)]
    first_atomic = routes.index("atomic") if "atomic" in routes else len(routes)
    assert routes[:first_atomic] == ["mma"] * first_atomic
    assert routes[first_atomic:] == ["atomic"] * (len(routes) - first_atomic)


@pytest.mark.parametrize("name", FLAGSHIPS)
def test_integer_stats_route_switches_once_and_no_later(name):
    """With integer stats (the atomic kernel's int32 cells) the route still
    switches once with depth, and never later than with float stats."""
    _, trees, depth = FLAGSHIPS[name]
    launches = shallow_launches(trees, S, depth)
    routes = [_hist_route(t_pack, nodes, S, B, integer_stats=True) for _, nodes, t_pack in launches]
    first_atomic = routes.index("atomic") if "atomic" in routes else len(routes)
    assert routes == ["mma"] * first_atomic + ["atomic"] * (len(routes) - first_atomic)
    assert routes[0] == "mma"
    float_routes = [_hist_route(t_pack, nodes, S, B) for _, nodes, t_pack in launches]
    assert first_atomic <= (float_routes.index("atomic") if "atomic" in float_routes else len(float_routes))


@pytest.mark.parametrize(
    "f_pad,n,n_bins",
    [(64, FLAGSHIP_N, 128), (1024, FLAGSHIP_N, 128), (7, 3001, 16), (3, 77, 7), (200, 128, 100), (1, 1, 1)],
)
def test_mma_geometry_splits_cover_every_row_tile(f_pad, n, n_bins):
    splits, per_split = _mma_geometry(f_pad, n, n_bins)
    tiles = -(-n // MMA_ROWS_TILE)
    assert splits >= 1 and per_split >= 1
    assert splits * per_split >= tiles > (splits - 1) * per_split


def _inputs(seed, f_pad, n, t_pack, nodes, n_bins, integer, stray):
    rng = np.random.default_rng(seed)
    lo, hi = (-3, n_bins + 3) if stray else (0, n_bins)
    bins = rng.integers(lo, hi, (f_pad, n)).astype(np.int8)
    node = rng.integers(-1 if stray else 0, nodes + 2, (t_pack, n)).astype(np.int32)
    if stray:
        node[rng.random((t_pack, n)) < 0.05] = 1 << 18  # the deep phase's stray rows
    if integer:
        counts = rng.poisson(1.0, (t_pack, n)).astype(np.float32)
        y = rng.integers(0, S, n)
        stats = np.concatenate([counts[t][None] * (y[None] == np.arange(S)[:, None]) for t in range(t_pack)])
    else:
        stats = rng.random((t_pack * S, n))
    return bins, node, np.ascontiguousarray(stats, dtype=np.float32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (f_pad, n, t_pack, nodes, n_bins, stray): ragged rows, bins not a
# multiple of 16, out-of-range bins and node ids
PLAIN_SHAPES = [
    (32, 4096, 3, 4, 16, False),
    (5, 1000, 2, 3, 100, True),
    (3, 77, 1, 1, 7, True),
    (9, 3001, 50, 1, 128, True),
]


@pytest.mark.parametrize("kind", ["integer", "float"])
@pytest.mark.parametrize("f_pad,n,t_pack,nodes,n_bins,stray", PLAIN_SHAPES)
def test_onehot_plain_matches_plain(kind, f_pad, n, t_pack, nodes, n_bins, stray):
    bins, node, stats = _torch(*_inputs(4, f_pad, n, t_pack, nodes, n_bins, kind == "integer", stray))
    args = (t_pack, nodes, S, n_bins)
    H = node_histograms_onehot_plain(bins, node, stats, *args)
    want = node_histograms_plain(bins, node, stats, *args)
    assert H.shape == (f_pad, 128, n_bins) and H.dtype == torch.float32
    if kind == "integer":
        torch.testing.assert_close(H, want, rtol=0, atol=0)
    else:
        torch.testing.assert_close(H, want, rtol=1e-5, atol=1e-5)
    # the tensor-core wrapper takes this plain version on CPU tensors
    torch.testing.assert_close(node_histograms_mma(bins, node, stats, *args), H, rtol=0, atol=0)


# (f_pad, n, t_pack, nodes, n_bins, stray) in the JAX kernel's tiling:
# rows a multiple of 2048, features of 32
JAX_SHAPES = [(32, 4096, 3, 4, 16, False), (32, 2048, 4, 2, 128, True), (32, 2048, 1, 64, 32, True)]


@pytest.fixture(scope="module", params=[(shape, kind) for shape in JAX_SHAPES for kind in ("integer", "float")],
                ids=lambda p: f"{p[0][2]}x{p[0][3]}x{p[0][4]}-{p[1]}")
def jax_case(request):
    (f_pad, n, t_pack, nodes, n_bins, stray), kind = request.param
    bins, node, stats = _inputs(5, f_pad, n, t_pack, nodes, n_bins, kind == "integer", stray)
    H_ref = np.asarray(
        ref.node_histograms(
            jnp.asarray(bins), jnp.asarray(node), jnp.asarray(stats),
            t_pack=t_pack, nodes=nodes, s_dim=S, n_bins=n_bins, interpret=True,
        )
    )
    return kind, (bins, node, stats), (t_pack, nodes, S, n_bins), H_ref


def test_onehot_plain_matches_jax_kernel(jax_case):
    kind, arrays, args, H_ref = jax_case
    H = node_histograms_onehot_plain(*_torch(*arrays), *args).numpy()
    if kind == "integer":
        np.testing.assert_array_equal(H, H_ref)
    else:
        np.testing.assert_allclose(H, H_ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_both_routes_match_jax_kernel_on_cpu(jax_case):
    kind, arrays, args, H_ref = jax_case
    for route in (node_histograms_mma, node_histograms_atomic, node_histograms):
        H = route(*_torch(*arrays), *args).numpy()
        if kind == "integer":
            np.testing.assert_array_equal(H, H_ref)
        else:
            np.testing.assert_allclose(H, H_ref, rtol=BF16_RTOL, atol=BF16_ATOL)


def test_route_wrappers_check_their_inputs(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda name: pytest.fail("reached the launch"))
    bins = torch.zeros((32, 1024), dtype=torch.int8)
    node = torch.zeros((2, 1024), dtype=torch.int32)
    stats = torch.zeros((4, 1024))
    for route in (node_histograms_mma, node_histograms_atomic):
        with pytest.raises(ValueError):
            route(bins, node[:1], stats, 2, 4, 2, 16)
        with pytest.raises(ValueError):
            route(bins, node, stats, 2, 64, 2, 16)  # 256 slots
        with pytest.raises(TypeError):
            route(bins.int(), node, stats, 2, 4, 2, 16)
        with pytest.raises(ValueError, match="cpu or cuda"):
            route(*(t.to("meta") for t in (bins, node, stats)), 2, 4, 2, 16)
