# The port's in-mesh layer (spark_rapids_ml_tpu_torch: device lists,
# parallel/mesh.py, parallel/topology.py, parallel/exchange.py and the B11
# wrapper ops/exchange_kernels.py) against the JAX package's on the same
# inputs, on the CPU: the port drives 8 shards of ["cpu"] * 8 from one
# process, the JAX package its 8 forced CPU devices (conftest) inside
# shard_map.  The movement collectives and integer sums are held bit for bit;
# float sums within 1e-6 relative (both sum 8 partials, in orders that may
# differ).
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from spark_rapids_ml_tpu import profiling as ref_profiling
from spark_rapids_ml_tpu.compat import shard_map
from spark_rapids_ml_tpu.parallel import exchange as ref_exchange
from spark_rapids_ml_tpu.parallel import mesh as ref_mesh
from spark_rapids_ml_tpu.parallel import topology as ref_topology

import spark_rapids_ml_tpu_torch as port
from spark_rapids_ml_tpu_torch import profiling
from spark_rapids_ml_tpu_torch.device import use_device
from spark_rapids_ml_tpu_torch.ops import exchange_kernels
from spark_rapids_ml_tpu_torch.parallel import exchange, mesh, topology

N_DEV = 8
FLOAT_RTOL = 1e-6
CPU = torch.device("cpu")


def _jax_mesh(order=None):
    devs = jax.devices()[:N_DEV]
    if order is not None:
        devs = [devs[i] for i in order]
    return JaxMesh(np.array(devs), (ref_mesh.DATA_AXIS,))


def _blocks(dtype, rows=6, cols=5, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-1000, 1000, size=(N_DEV * rows, cols)).astype(np.int32)
    return rng.standard_normal((N_DEV * rows, cols)).astype(np.float32)


def _port_shards(x):
    rows = x.shape[0] // N_DEV
    return [torch.from_numpy(x[i * rows : (i + 1) * rows].copy()) for i in range(N_DEV)]


# the hierarchical maps of both packages: 2 hosts of 4, and the interleaved
# groups a shuffled device list gives ((0, 2, 4, 6), (1, 3, 5, 7))
_HIER = ((0, 1, 2, 3), (4, 5, 6, 7))
_INTERLEAVED = ((0, 2, 4, 6), (1, 3, 5, 7))


def _maps(groups):
    if groups is None:
        return None, None
    return (ref_topology.TopologyMap(groups=groups, source="env"),
            topology.TopologyMap(groups=groups, source="override"))


# -- the device list and the mesh ---------------------------------------------


def test_device_list_and_mesh():
    with use_device(["cpu"] * N_DEV):
        assert port.device.devices() == (torch.device("cpu"),) * N_DEV
        assert port.device.resolve() == torch.device("cpu")
        assert mesh.default_num_workers() == N_DEV
        assert mesh.get_mesh().shape == {mesh.DATA_AXIS: N_DEV}
        assert mesh.get_mesh(3).size == 3 and mesh.get_mesh(20).size == N_DEV
        assert port.NearestNeighbors().num_workers == N_DEV
        assert port.NearestNeighbors(num_workers=2).num_workers == 2
        with use_device("cpu"):
            assert mesh.get_mesh().devices == (torch.device("cpu"),)
        assert mesh.get_mesh(2) == mesh.Mesh((CPU, CPU)) and hash(mesh.get_mesh(2)) == hash(mesh.Mesh([CPU] * 2))
    with pytest.raises(ValueError):
        use_device([])
    with pytest.raises(ValueError):
        mesh.Mesh(())


def test_device_list_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with use_device(None):
        with pytest.raises(RuntimeError, match="use_device"):
            port.device.devices()
        with pytest.raises(RuntimeError, match="use_device"):
            mesh.get_mesh()
    with use_device(["cuda:0"] * 4):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.get_mesh()


@pytest.mark.parametrize("n_dev", [1, 2, 6, 8])
def test_mesh_helpers_match_jax(n_dev):
    jm = JaxMesh(np.array(jax.devices()[:n_dev]), (ref_mesh.DATA_AXIS,))
    pm = mesh.Mesh((CPU,) * n_dev)
    for shift in (1, -1, 3):
        assert mesh.ring_permutation(n_dev, shift) == ref_mesh.ring_permutation(n_dev, shift)
    for n in (0, 1, 63, 64, 65, 1000):
        assert mesh.padded_row_count(n, pm) == ref_mesh.padded_row_count(n, jm)
        assert mesh.padded_row_count(n) == ref_mesh.padded_row_count(n)
    x = _blocks(np.float32, rows=5)[:37]
    want, want_valid = ref_mesh.shard_rows(x, jm)
    got, got_valid = mesh.shard_rows(x, pm)
    assert got_valid == want_valid == 37 and len(got) == n_dev
    np.testing.assert_array_equal(torch.cat(got).numpy(), np.asarray(want))


# -- the topology ---------------------------------------------------------------


_TOPO_CASES = [
    # (devices given to the port, the JAX device order, SRML_TOPO, pin_flat)
    ("cpu", None, None, False),
    ("cpu", None, "2:4", False),
    ("cpu", None, "2:4", True),
    ("cpu", None, "4:2", False),
    ("cpu", None, "3:3", False),     # 3 + 3 + 2 shards: unequal groups, flat schedule
    ("cuda", [0, 4, 1, 5, 2, 6, 3, 7], "2:4", False),  # distinct devices grouped by index
]


@pytest.mark.parametrize("kind,order,topo_env,pin", _TOPO_CASES)
def test_topology_map_matches_jax(monkeypatch, kind, order, topo_env, pin):
    if topo_env:
        monkeypatch.setenv(ref_topology.TOPO_ENV, topo_env)
    if pin:
        monkeypatch.setenv(ref_topology.EXCHANGE_TOPO_ENV, "flat")
    want = ref_topology.topology_map(mesh=_jax_mesh(order))
    if kind == "cpu":
        devices = [torch.device("cpu")] * N_DEV
    else:  # device objects only: nothing runs on them
        devices = [torch.device("cuda", i) for i in order]
    dph = int(topo_env.split(":")[1]) if topo_env else None
    got = topology.topology_map(devices=devices, devs_per_host=dph, pin_flat=pin)
    assert got.groups == want.groups and got.pinned == want.pinned
    assert got.schedule == want.schedule and got.describe() == want.describe()
    assert got.gateways == want.gateways and got.group_of == want.group_of
    assert topology.topology_map(mesh=mesh.Mesh(devices), devs_per_host=dph, pin_flat=pin) == got
    for shift in (1, -1, 3, 8):
        assert topology.ring_cycle(got, shift) == ref_topology.ring_cycle(want, shift)
    for nbytes in (0, 4, 1000):
        assert topology.link_split_gather(got, nbytes) == ref_topology.link_split_gather(want, nbytes)
        assert topology.link_split_reduce(got, nbytes) == ref_topology.link_split_reduce(want, nbytes)
        assert topology.link_split_ring_hop(got, nbytes) == ref_topology.link_split_ring_hop(want, nbytes)
    major = [p for g in want.groups for p in g] if want.n_groups > 1 else list(range(N_DEV))
    jax_devices = list(_jax_mesh(order).devices.flat)
    assert ref_topology.group_major_devices(jax_devices) == [jax_devices[p] for p in major]
    assert topology.group_major_devices(devices, devs_per_host=dph) == [devices[p] for p in major]


def test_topology_rejects_bad_input():
    with pytest.raises(ValueError):
        topology.topology_map()
    with pytest.raises(ValueError):
        topology.topology_map(n_devices=0)
    with pytest.raises(ValueError):
        topology.topology_map(n_devices=4, devs_per_host=0)
    assert topology.topology_map(n_devices=4) == topology.flat_topology(4)


# -- the collectives against the JAX package's inside shard_map ----------------


def _jax_collective(method, x, groups, replicated, **kw):
    ref_topo, _ = _maps(groups)
    sec = ref_exchange.device_collective("t.mesh", ref_topo)

    def body(blk):
        return getattr(sec, method)(blk, **kw)

    out = shard_map(
        body, mesh=_jax_mesh(), in_specs=P(ref_mesh.DATA_AXIS),
        out_specs=P() if replicated else P(ref_mesh.DATA_AXIS), check_vma=False,
    )(jnp.asarray(x))
    return np.asarray(out)


def _port_collective(method, x, groups, **kw):
    _, topo = _maps(groups)
    profiling.reset_counters("exchange.t.mesh")
    out = getattr(exchange.device_collective("t.mesh", topo), method)(_port_shards(x), **kw)
    return out, profiling.counters("exchange.t.mesh")


@pytest.mark.parametrize("groups", [None, _HIER, _INTERLEAVED], ids=["flat", "hier", "interleaved"])
@pytest.mark.parametrize("method", ["allgather_rows", "gather_stack", "psum_merge"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
def test_movement_collectives_bitwise(method, groups, dtype):
    x = _blocks(dtype)
    want = _jax_collective(method, x, groups, replicated=True)
    got, ctr = _port_collective(method, x, groups)
    assert len(got) == N_DEV and all(t is got[0] for t in got)  # one device: one shared tensor
    np.testing.assert_array_equal(got[0].numpy(), want)
    nbytes = x.nbytes // N_DEV
    topo = _maps(groups)[1] or topology.flat_topology(N_DEV)
    ici, dcn = topology.link_split_gather(topo, nbytes)
    assert ctr["exchange.t.mesh.bytes"] == nbytes and ctr["exchange.t.mesh.calls"] == 1
    assert ctr.get("exchange.t.mesh.ici_bytes", 0) == ici and ctr.get("exchange.t.mesh.dcn_bytes", 0) == dcn


@pytest.mark.parametrize("groups", [None, _HIER, _INTERLEAVED], ids=["flat", "hier", "interleaved"])
def test_gather_to_first_is_the_gathered_slab(groups):
    """gather_to_first returns gather_stack's slab (the JAX package's
    replicated gather) as one tensor on shard 0's device, counted alike."""
    x = _blocks(np.float32, seed=2)
    want = _jax_collective("gather_stack", x, groups, replicated=True)
    got, ctr = _port_collective("gather_to_first", x, groups)
    assert isinstance(got, torch.Tensor) and got.device == _port_shards(x)[0].device
    np.testing.assert_array_equal(got.numpy(), want)
    _, stack_ctr = _port_collective("gather_stack", x, groups)
    assert {k: v for k, v in ctr.items() if not k.endswith("time_ns")} == {
        k: v for k, v in stack_ctr.items() if not k.endswith("time_ns")}


@pytest.mark.parametrize("groups", [None, _HIER], ids=["flat", "hier"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
def test_psum(groups, dtype):
    x = _blocks(dtype, seed=3)
    want = _jax_collective("psum", x, groups, replicated=True)
    got, ctr = _port_collective("psum", x, groups)
    assert want.shape == tuple(got[0].shape) == (x.shape[0] // N_DEV, x.shape[1])
    if dtype == np.int32:
        np.testing.assert_array_equal(got[0].numpy(), want)
    else:
        np.testing.assert_allclose(got[0].numpy(), want, rtol=FLOAT_RTOL, atol=FLOAT_RTOL)
    topo = _maps(groups)[1] or topology.flat_topology(N_DEV)
    ici, dcn = topology.link_split_reduce(topo, x.nbytes // N_DEV)
    assert ctr.get("exchange.t.mesh.ici_bytes", 0) == ici and ctr.get("exchange.t.mesh.dcn_bytes", 0) == dcn
    # the inputs are left as they were
    np.testing.assert_array_equal(torch.cat(_port_shards(x)).numpy(), x)


@pytest.mark.parametrize("groups", [None, _HIER, _INTERLEAVED], ids=["flat", "hier", "interleaved"])
@pytest.mark.parametrize("shift", [1, -1, 3, 8])
def test_ring_shift_bitwise(groups, shift):
    x = _blocks(np.float32, seed=5)
    want = _jax_collective("ring_shift", x, groups, replicated=False, shift=shift)
    got, ctr = _port_collective("ring_shift", x, groups, shift=shift)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    topo = _maps(groups)[1] or topology.flat_topology(N_DEV)
    ici, dcn = topology.link_split_ring_hop(topo, x.nbytes // N_DEV)
    assert ctr["exchange.t.mesh.bytes"] == x.nbytes // N_DEV
    assert ctr.get("exchange.t.mesh.ici_bytes", 0) == ici and ctr.get("exchange.t.mesh.dcn_bytes", 0) == dcn


def test_section_counters_match_jax():
    """The port counts per call what the JAX package counts per trace: one
    call of each collective gives the same `.bytes` / `.ici_bytes` /
    `.dcn_bytes` in both packages."""
    x = _blocks(np.float32, seed=6)
    for method, kw in (("allgather_rows", {}), ("psum", {}), ("ring_shift", {"shift": 1})):
        ref_profiling.reset_counters("exchange.t.mesh")
        _jax_collective(method, x, _HIER, replicated=method != "ring_shift", **kw)
        want = {k: v for k, v in ref_profiling.counters("exchange.t.mesh").items() if k.endswith("bytes")}
        _, ctr = _port_collective(method, x, _HIER, **kw)
        assert {k: v for k, v in ctr.items() if k.endswith("bytes")} == want, method


def test_ring_shift_one_shard_returns_its_input(monkeypatch):
    calls = []
    monkeypatch.setattr(exchange_kernels, "ring_shift", lambda *a: calls.append(a))
    x = torch.arange(6.0).reshape(2, 3)
    assert exchange.device_collective("t.one").ring_shift([x], shift=3)[0] is x
    assert exchange.ring_shift([x])[0] is x
    assert calls == []  # the kernel's wrapper was never called


def test_shims_and_totals():
    x = _blocks(np.int32, seed=7)
    profiling.reset_counters("exchange.")
    shards = _port_shards(x)
    np.testing.assert_array_equal(exchange.allgather_rows(shards)[0].numpy(), x)
    np.testing.assert_array_equal(exchange.psum_parts(shards)[0].numpy(), x.reshape(N_DEV, -1, x.shape[1]).sum(0))
    np.testing.assert_array_equal(exchange.psum_merge_parts(shards)[0].numpy(), x.reshape(N_DEV, -1, x.shape[1]))
    np.testing.assert_array_equal(torch.cat(exchange.ring_shift(shards, shift=-1)).numpy(), np.roll(x, -6, axis=0))
    total, per = exchange.byte_totals()
    assert set(per) == {"allgather_rows", "psum_parts", "psum_merge_parts", "ring_shift"}
    assert total == 4 * (x.nbytes // N_DEV)
    assert exchange.link_totals() == {"ici": 56 * 120 + 56 * 120 + 56 * 120 + 8 * 120, "dcn": 0}
    profiling.reset_counters("exchange.")


# -- the B11 wrapper -------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8])
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ring_shift_wrapper_is_a_roll(dtype, shift):
    g = torch.Generator().manual_seed(1)
    stacked = torch.randint(0, 100, (4, 3, 7), generator=g).to(dtype)
    perm = mesh.ring_permutation(4, shift)
    out = exchange_kernels.ring_shift(list(stacked.unbind(0)), perm)
    assert torch.equal(torch.stack(out), torch.roll(stacked, shift, 0))
    assert all(torch.equal(a, b) for a, b in zip(out, exchange_kernels.ring_shift_plain(list(stacked.unbind(0)), perm)))
    assert all(o.data_ptr() != s.data_ptr() for o in out for s in stacked.unbind(0))  # out of place


def test_ring_shift_wrapper_rejections():
    blocks = [torch.zeros(4, 3) for _ in range(4)]
    rot = mesh.ring_permutation(4, 1)
    cases = [
        (blocks[:3] + [torch.zeros(4, 2)], rot, "shape"),
        (blocks[:3] + [torch.zeros(4, 3, dtype=torch.int32)], rot, "int32"),
        ([torch.zeros(2)] * 65, mesh.ring_permutation(65, 1), "1 to 64"),
        ([], [], "1 to 64"),
        (blocks, [(0, 1), (1, 1), (2, 3), (3, 0)], "once"),
        (blocks, rot[:3], "once"),
        ([torch.zeros(3, 4).t()] * 4, rot, "contiguous"),
        (blocks[:3] + [torch.zeros(4, 3, device="meta")], rot, "cpu tensors or on cuda"),
    ]
    for srcs, perm, match in cases:
        with pytest.raises(ValueError, match=match):
            exchange_kernels.ring_shift(srcs, perm)
    assert exchange_kernels.MAX_PAIRS == 64
