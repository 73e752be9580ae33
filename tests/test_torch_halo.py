"""The halo-exchange SpMM of the distributed trainer against the dense
A·x and the JAX package's ``halo_spmm_ell`` / ``halo_spmm`` under
``shard_map`` (the conftest's 8 virtual CPU devices), forward and gradient
of Σ(A·x)², at 1, 2 and 8 shards on one gloo rank; the kernels run their
plain versions here.  Tolerances: the JAX tests' (rtol 2e-4, atol 1e-4)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from tpugraph.dist.halo import halo_spmm as jax_halo_spmm
from tpugraph.dist.halo import halo_spmm_ell as jax_halo_spmm_ell
from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.halo_ell import squeeze_shard
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph_torch.dist.halo import exchange, halo_spmm, halo_spmm_ell
from tpugraph_torch.dist.mesh import make_mesh, shard_operator
from tpugraph_torch.dist.mp_worker import halo_graph
from tpugraph_torch.kernels import spmm as spmm_mod
from tpugraph_torch.kernels import spmm_ell
from tpugraph_torch.sparse.build import coo_to_dense
from tpugraph_torch.sparse.partition import partition_edges

TOL = dict(rtol=2e-4, atol=1e-4)
N = 96


def _jax_halo(hg_np, impl, x):
    """JAX's halo SpMM and the gradient of Σ out² over the padded table."""
    s = hg_np.n_shards
    mesh = jax_make_mesh(s, 1)
    src, dst, w = halo_graph()
    jhg = jax_partition_edges(src, dst, w, N, s)
    if impl == "ell":
        he = jax_build_halo_ell(jhg)

        @partial(shard_map, mesh=mesh, in_specs=(P("graph", None), P("graph")),
                 out_specs=P("graph", None))
        def run(x_local, he_s):
            he_s = squeeze_shard(he_s)
            return jax_halo_spmm_ell(x_local, he_s.loc, he_s.bnd,
                                     he_s.send_idx.reshape(s, he.halo_b),
                                     he_s.send_mask.reshape(s, he.halo_b))
        arg = he
    else:
        @partial(shard_map, mesh=mesh, in_specs=(P("graph", None), P("graph")),
                 out_specs=P("graph", None))
        def run(x_local, h):
            return jax_halo_spmm(
                x_local, h.loc_src.reshape(-1), h.loc_dst.reshape(-1), h.loc_w.reshape(-1),
                h.bnd_src.reshape(-1), h.bnd_dst.reshape(-1), h.bnd_w.reshape(-1),
                h.send_idx.reshape(s, jhg.halo_b), h.send_mask.reshape(s, jhg.halo_b))
        arg = jhg
    with mesh:
        out = np.asarray(jax.jit(run)(jnp.asarray(x), arg))
        grad = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(run(v, arg) ** 2)))(jnp.asarray(x)))
    return out, grad


@pytest.mark.parametrize("impl", ["ell", "sorted"])
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_halo_spmm_matches_dense_and_jax(n_shards, impl):
    src, dst, w = halo_graph()
    hg = partition_edges(src, dst, w, N, n_shards)
    n_pad = hg.n_loc * n_shards
    x = np.zeros((n_pad, 8), np.float32)
    x[:N] = np.random.default_rng(1).standard_normal((N, 8))
    a = coo_to_dense(src, dst, w, N, N)
    fn = halo_spmm_ell if impl == "ell" else halo_spmm
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        op = shard_operator(hg, mesh, impl)
        assert op.has_halo == (n_shards > 1)
        xt = torch.from_numpy(x).requires_grad_()
        out = fn(xt, op)
        (out ** 2).sum().backward()
    out, grad = out.detach().numpy(), xt.grad.numpy()
    np.testing.assert_allclose(out[:N], a @ x[:N], **TOL)
    np.testing.assert_allclose(out[N:], 0.0, atol=1e-6)
    np.testing.assert_allclose(grad[:N], 2 * a.T @ (a @ x[:N]), **TOL)
    j_out, j_grad = _jax_halo(hg, impl, x)
    np.testing.assert_allclose(out, j_out, **TOL)
    np.testing.assert_allclose(grad, j_grad, **TOL)


def test_exchange_delivers_the_send_rows_and_returns_their_gradient():
    """Each shard's receive buffer holds, at slot (owner o, j), row
    send_idx[o, s, j] of shard o (zero at pad slots); the backward adds each
    returned row into the sender's row."""
    src, dst, w = halo_graph()
    hg = partition_edges(src, dst, w, N, 4)
    nl, b = hg.n_loc, hg.halo_b
    x = torch.arange(nl * 4 * 3, dtype=torch.float32).reshape(nl * 4, 3).requires_grad_()
    with make_mesh(4, torch.device("cpu")) as mesh:
        recv = exchange(x, shard_operator(hg, mesh, "ell"))
        g = torch.randn_like(recv)
        recv.backward(g)
    want_g = torch.zeros_like(x)
    for s in range(4):
        for o in range(4):
            for j in range(b):
                row = o * nl + int(hg.send_idx[o, s, j])
                live = float(hg.send_mask[o, s, j])
                assert torch.equal(recv[s, o * b + j], x[row].detach() * live)
                want_g[row] += g[s, o * b + j] * live
    torch.testing.assert_close(x.grad, want_g)


def test_kernel_launch_counts_on_the_host_stay_zero():
    """On the host the wrappers run the plain versions and count nothing;
    the card's count (2 launches per shard and direction) is read by
    chip_smoke.py."""
    src, dst, w = halo_graph()
    hg = partition_edges(src, dst, w, N, 2)
    before = (spmm_ell.launches, spmm_mod.launches)
    with make_mesh(2, torch.device("cpu")) as mesh:
        for impl, fn in (("ell", halo_spmm_ell), ("sorted", halo_spmm)):
            x = torch.zeros(hg.n_loc * 2, 4, requires_grad=True)
            fn(x, shard_operator(hg, mesh, impl)).sum().backward()
    assert (spmm_ell.launches, spmm_mod.launches) == before
