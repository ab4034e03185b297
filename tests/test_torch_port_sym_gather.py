"""Port reverse-edge index and gather-based sender-gather backward against
the JAX ``sgnn_tpu/ops/sym_gather.py``, on CPU."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgnn_tpu.ops import radius_neighbors_bruteforce
from sgnn_tpu.ops import sym_gather as jsg
from sgnn_tpu_torch.ops import sym_gather as tsg

torch.set_num_threads(1)


def symmetric_graph(rng, n=60, k=24, radius=0.5):
    """A radius graph whose cap never binds, so it is symmetric."""
    pos = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    nl = radius_neighbors_bruteforce(jnp.asarray(pos), radius, max_neighbors=k)
    assert int(np.asarray(nl.mask).sum(1).max()) < k
    return np.array(nl.senders), np.array(nl.mask)


def test_reverse_edge_positions_equal_jax(rng):
    senders, mask = symmetric_graph(rng)
    want_pos, want_ok = jsg.reverse_edge_positions(jnp.asarray(senders), jnp.asarray(mask))
    got_pos, got_ok = tsg.reverse_edge_positions(torch.from_numpy(senders), torch.from_numpy(mask))
    assert got_pos.dtype == torch.int32
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(got_ok.numpy(), mask)  # symmetric and uncapped


def test_reverse_edge_positions_on_a_capped_graph_equal_jax(rng):
    """Where the cap binds some reverse edges are missing: rev_ok says so."""
    pos = rng.uniform(-1, 1, size=(50, 2)).astype(np.float32)
    nl = radius_neighbors_bruteforce(jnp.asarray(pos), 0.6, max_neighbors=6)
    senders, mask = np.array(nl.senders), np.array(nl.mask)
    want_pos, want_ok = jsg.reverse_edge_positions(jnp.asarray(senders), jnp.asarray(mask))
    got_pos, got_ok = tsg.reverse_edge_positions(torch.from_numpy(senders), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    assert not got_ok.numpy()[mask].all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sym_gather_grad_equals_jax_and_index_select(rng, dtype):
    senders, mask = symmetric_graph(rng)
    n, k = senders.shape
    h = 16
    table = rng.normal(size=(n, h)).astype(np.float32)
    cot = rng.normal(size=(n * k, h)).astype(np.float32)
    rev_pos, rev_ok = jsg.reverse_edge_positions(jnp.asarray(senders), jnp.asarray(mask))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)

    flat = jnp.asarray(senders.reshape(-1))
    _, vjp = jax.vjp(lambda t: jsg.sym_gather(t, flat, rev_pos, rev_ok), jnp.asarray(table).astype(jdt))
    (want,) = vjp(jnp.asarray(cot).astype(jdt))

    t = torch.from_numpy(table).to(tdt).requires_grad_(True)
    idx = torch.from_numpy(senders.reshape(-1)).long()
    tp, tok = tsg.reverse_edge_positions(torch.from_numpy(senders), torch.from_numpy(mask))
    before = tsg.BWD_CALLS
    out = tsg.sym_gather(t, idx, tp, tok)
    assert torch.equal(out, t.detach().index_select(0, idx))
    out.backward(torch.from_numpy(cot).to(tdt))
    assert tsg.BWD_CALLS == before + 1
    assert t.grad.dtype == tdt
    # f32 sums of <= 24 terms in another order than JAX's identity dot;
    # in bf16 that can flip the rounding of the cast (2^-8 relative)
    tol = dict(rtol=1e-6, atol=1e-5) if dtype == "float32" else dict(rtol=2.0**-8, atol=1e-5)
    np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)

    if dtype == "float32":
        # the scatter-add of index_select's backward: the same sums, in
        # another order, over the masked slots only (padded slots carry
        # the receiver itself and a zero cotangent in the model)
        cot_masked = torch.from_numpy(cot) * torch.from_numpy(mask.reshape(-1, 1)).float()
        plain = torch.zeros(n, h).index_add_(0, idx, cot_masked)
        t2 = torch.from_numpy(table).requires_grad_(True)
        tsg.sym_gather(t2, idx, tp, tok).backward(cot_masked)
        torch.testing.assert_close(t2.grad, plain, rtol=1e-6, atol=1e-6)


def test_banded_gather_is_not_ported(rng):
    senders, mask = symmetric_graph(rng, n=20, k=24)
    tp, tok = tsg.reverse_edge_positions(torch.from_numpy(senders), torch.from_numpy(mask))
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        tsg.sym_gather(torch.zeros(20, 4), torch.from_numpy(senders.reshape(-1)).long(), tp, tok, band_nodes=8)
