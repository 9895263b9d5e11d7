"""The port's multi-process runtime (effort_tpu_torch/parallel/multihost.py)
and its collectives (parallel/collectives.py): init_multihost degrades to
one process (tests/test_multihost.py), make_pod_mesh's rank order is the
JAX package's device order, a (dp 2, tp 4) pod mesh of 8 spawned ranks
runs a psum, each collective equals its jax.lax counterpart on 4 ranks,
and spawn reports a failing rank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.distributed as dist
from jax.experimental import mesh_utils
from jax.sharding import PartitionSpec as P

from effort_tpu.parallel import shard_map
from effort_tpu.parallel.multihost import make_pod_mesh as jax_pod_mesh
from effort_tpu.parallel.sp import make_sp_mesh as jax_1d_mesh
from effort_tpu_torch.parallel import _ranks, multihost

N = 4
PERM = [(0, 1), (1, 2), (2, 0)]          # rank 3 sends and receives none


@dataclasses.dataclass(frozen=True)
class _Device:
    """What create_hybrid_device_mesh reads of a device."""
    id: int
    process_index: int
    platform: str = "cpu"
    device_kind: str = "cpu"
    slice_index: int = 0


def _hybrid_ids(dcn, ici, n_hosts: int) -> np.ndarray:
    """The device ids of JAX's multi-host make_pod_mesh branch: the
    hybrid mesh of per-host granules, reshaped to dcn * ici per axis."""
    n_local = int(np.prod(ici))
    devs = [_Device(i, i // n_local) for i in range(n_hosts * n_local)]
    arr = mesh_utils.create_hybrid_device_mesh(ici, dcn, devices=devs,
                                               process_is_granule=True)
    shape = tuple(d * i for d, i in zip(dcn, ici))
    return np.vectorize(lambda d: d.id)(arr.reshape(shape))


POD_CASES = [((1, 1), (2, 4), 1), ((2, 1), (1, 4), 2), ((1, 2), (2, 2), 2)]


@pytest.fixture(scope="module")
def ran():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, 6)).astype(np.float32)
    a2a = rng.standard_normal((N, N * 2, N)).astype(np.float32)
    col = multihost.spawn(_ranks.run_jobs, N, "gloo", "cpu",
                          [dict(kind="collectives", x=x, a2a=a2a,
                                perm=PERM)], timeout=300)
    pod = multihost.spawn(
        _ranks.run_jobs, 8, "gloo", "cpu",
        [dict(kind="pod_mesh", n_hosts=1, cases=[((1,), (2, 4))],
              x=np.arange(8.0)),
         dict(kind="pod_mesh", n_hosts=2,
              cases=[(d, i) for d, i, h in POD_CASES[1:]], x=np.arange(8.0))],
        timeout=300)
    return dict(x=x, a2a=a2a, col=[r[0] for r in col],
                pods=dict(one_host=[r[0] for r in pod],
                          two_hosts=[r[1] for r in pod]))


def test_init_single_process_noop():
    """With nothing to join: (0, 1), and no process group made."""
    assert multihost.init_multihost() == (0, 1)
    assert not dist.is_initialized()


def test_pod_mesh_single_process(ran):
    """dp 2 x tp 4 over 8 ranks on one host: the mesh's shape and JAX's
    device order, and a psum over "tp" of arange(8) gives 6 and 22."""
    jax_ids = np.vectorize(lambda d: d.id)(jax_pod_mesh(
        ("dp", "tp"), dcn_axes=(1,), ici_axes=(2, 4)).devices)
    for r, res in enumerate(ran["pods"]["one_host"]):
        assert res["shape"] == (2, 4)
        np.testing.assert_array_equal(res["ranks"][0], jax_ids)
        assert res["psum"] == (6.0 if r < 4 else 22.0)


@pytest.mark.parametrize("case", POD_CASES, ids=["1host", "dcn21",
                                                 "dcn12"])
def test_pod_mesh_rank_order_matches_jax(ran, case):
    """Host-major rank order: pod_mesh_ranks, and the DeviceMesh that 8
    spawned ranks build, equal the device order of JAX's
    create_hybrid_device_mesh (its make_pod_mesh across hosts) for
    dcn_axes (2, 1) and (1, 2) over 2 hosts of 4."""
    dcn, ici, hosts = case
    want = _hybrid_ids(dcn, ici, hosts) if hosts > 1 else np.arange(
        8).reshape(2, 4)
    np.testing.assert_array_equal(multihost.pod_mesh_ranks(dcn, ici, hosts),
                                  want)
    if hosts > 1:
        k = POD_CASES[1:].index(case)
        for res in ran["pods"]["two_hosts"]:
            np.testing.assert_array_equal(res["ranks"][k], want)


def test_collectives_match_jax(ran):
    """axis_index, psum, pmax, all_gather (tiled and stacked), all_to_all
    (split 0 / concat 0, and split 1 / concat 0) and ppermute on 4 ranks
    equal jax.lax's in shard_map over 4 devices, on the same rows; the
    input is left as it was."""
    mesh = jax_1d_mesh(N)

    def f(x, a):
        x, a = x[0], a[0]
        ax = "sp"
        return (jax.lax.axis_index(ax)[None], jax.lax.psum(x, ax)[None],
                jax.lax.pmax(x, ax)[None],
                jax.lax.all_gather(x, ax, tiled=True)[None],
                jax.lax.all_gather(x, ax)[None],
                jax.lax.all_to_all(a, ax, 0, 0, tiled=True)[None],
                jax.lax.all_to_all(a, ax, 1, 0, tiled=True)[None],
                jax.lax.ppermute(x, ax, PERM)[None])
    outs = jax.jit(shard_map(f, mesh=mesh, in_specs=(P("sp"), P("sp")),
                             out_specs=(P("sp"),) * 8))(
        jnp.asarray(ran["x"]), jnp.asarray(ran["a2a"]))
    names = ("axis_index", "psum", "pmax", "all_gather",
             "all_gather_stacked", "all_to_all", "all_to_all_1_0",
             "ppermute")
    for r, res in enumerate(ran["col"]):
        assert res["x_unchanged"]
        for name, o in zip(names, outs):
            np.testing.assert_allclose(np.asarray(res[name]),
                                       np.asarray(o)[r], rtol=1e-6,
                                       atol=0, err_msg=name)
    assert not ran["col"][3]["ppermute"].any()


def test_spawn_reports_a_failing_rank():
    """A rank that raises fails the whole spawn, with its traceback; no
    process is left running."""
    with pytest.raises(RuntimeError, match="rank 2 of 3 failed"):
        multihost.spawn(_ranks.fail_on, 3, "gloo", "cpu", 2, timeout=120)
    assert multihost.spawn(_ranks.fail_on, 2, "gloo", "cpu", 5,
                           timeout=120) == [0, 1]
