"""The port's recurrent mixers (``repro_torch.models.ssm``: the chunked
linear recurrence, mLSTM, sLSTM, SSD) against the JAX package's, on the CPU.

The reference has no Pallas kernel for these: both sides run plain array
ops. Parameters are made by the reference's init and carried across through
numpy; inputs come from numpy seeds. In f32 the two differ by the order of
f32 sums: within 1e-4 for passes through the chunked recurrence (the
reference's own tolerance for it, tests/test_models.py) and 1e-5
otherwise; bf16 within 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as jssm
from repro_torch.interop import lm_params_from_numpy
from repro_torch.models import ssm

CHUNK_TOL = 1e-4
TOL = 1e-5
BF16_TOL = 2e-2
D, HEADS, STATE = 64, 4, 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small cases: one intra-op thread runs them as fast, and leaves the
    cores to the tests other workers run beside them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x) -> torch.Tensor:
    return lm_params_from_numpy({"x": np.asarray(x)}, device="cpu")["x"]


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _params(init, *args, dtype=jnp.float32):
    jp = init(jax.random.PRNGKey(0), *args, dtype)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# ---------------------------------------------------------- the recurrence

def _recurrence_inputs(b, h, t, dk, dv, seed):
    q, k = _rand(b, h, t, dk, seed=seed), _rand(b, h, t, dk, seed=seed + 1)
    v = _rand(b, h, t, dv, seed=seed + 2)
    log_a = -np.abs(_rand(b, h, t, seed=seed + 3)) * 0.1
    return q, k, v, log_a


@pytest.mark.parametrize("t,chunk,with_state", [
    (25, 16, False),      # T needs padding to a chunk multiple
    (25, 16, True),
    (64, 16, True),
    (7, 128, False),      # one chunk shorter than the default
])
def test_chunked_linear_recurrence_matches(t, chunk, with_state):
    q, k, v, log_a = _recurrence_inputs(2, 3, t, 8, 5, seed=t)
    init = _rand(2, 3, 8, 5, seed=99) if with_state else None
    want_y, want_s = jssm.chunked_linear_recurrence(
        *map(jnp.asarray, (q, k, v, log_a)), chunk=chunk,
        init_state=None if init is None else jnp.asarray(init))
    got_y, got_s = ssm.chunked_linear_recurrence(
        *map(_t, (q, k, v, log_a)), chunk=chunk,
        init_state=None if init is None else _t(init))
    assert got_y.dtype == got_s.dtype == torch.float32
    assert tuple(got_y.shape) == (2, 3, t, 5) and tuple(got_s.shape) == (2, 3, 8, 5)
    _close(got_y, want_y, CHUNK_TOL)
    _close(got_s, want_s, CHUNK_TOL)


def test_linear_recurrence_step_matches():
    q, k, v, log_a = (x[:, :, 0] for x in _recurrence_inputs(2, 3, 1, 8, 5, seed=4))
    state = _rand(2, 3, 8, 5, seed=5)
    want_y, want_s = jssm.linear_recurrence_step(*map(jnp.asarray, (q, k, v, log_a, state)))
    got_y, got_s = ssm.linear_recurrence_step(*map(_t, (q, k, v, log_a, state)))
    _close(got_y, want_y, TOL)
    _close(got_s, want_s, TOL)


def test_chunked_gradient_stays_finite_past_exp_overflow():
    """A chunk whose decay passes ~88 nats: the reference takes exp of the
    masked (j > i) pairs too, which overflow, and its gradient with respect
    to log_a is NaN. The port masks them before the exp: the same outputs
    and a finite gradient, equal to the reference's at a decay where the
    reference's is finite."""
    def grads(decay):
        q, k, v, _ = _recurrence_inputs(1, 2, 128, 4, 4, seed=6)
        log_a = np.full((1, 2, 128), -decay, np.float32)

        def jloss(la):
            return jssm.chunked_linear_recurrence(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), la, chunk=128)[0].sum()

        want_y = jssm.chunked_linear_recurrence(
            *map(jnp.asarray, (q, k, v, log_a)), chunk=128)[0]
        want_g = jax.grad(jloss)(jnp.asarray(log_a))
        la = _t(log_a).requires_grad_()
        y = ssm.chunked_linear_recurrence(_t(q), _t(k), _t(v), la, chunk=128)[0]
        (g,) = torch.autograd.grad(y.sum(), la)
        return y, want_y, g, want_g

    y, want_y, g, want_g = grads(0.8)           # 0.8 * 127 = 101.6 nats
    _close(y, want_y, CHUNK_TOL)
    assert not bool(jnp.isfinite(want_g).all())
    assert bool(torch.isfinite(g).all())
    y, want_y, g, want_g = grads(0.3)           # 38 nats: both finite
    _close(y, want_y, CHUNK_TOL)
    assert bool(jnp.isfinite(want_g).all())
    scale = float(jnp.abs(want_g).max())
    assert float((g - _t(np.asarray(want_g))).abs().max()) <= CHUNK_TOL * scale


# ------------------------------------------------------------------ mLSTM

@pytest.mark.parametrize("t", [40, 16])
def test_mlstm_and_step_match(t):
    jp, p = _params(jssm.mlstm_init, D, HEADS)
    x = _rand(2, t, D, seed=7)
    want, jstate = jssm.mlstm(jp, jnp.asarray(x), HEADS, chunk=16)
    got, state = ssm.mlstm(p, _t(x), HEADS, chunk=16)
    assert tuple(state.c.shape) == (2, HEADS, D // HEADS, D // HEADS + 1)
    _close(got, want, CHUNK_TOL)
    _close(state.c, jstate.c, CHUNK_TOL)
    # two decode steps from that state
    for i in range(2):
        xt = _rand(2, 1, D, seed=8 + i)
        want, jstate = jssm.mlstm_step(jp, jnp.asarray(xt), jstate, HEADS)
        got, state = ssm.mlstm_step(p, _t(xt), state, HEADS)
        _close(got, want, TOL)
        _close(state.c, jstate.c, TOL)


def test_mlstm_matches_in_bf16():
    jp, p = _params(jssm.mlstm_init, D, HEADS, dtype=jnp.bfloat16)
    x = _rand(2, 40, D, seed=10)
    want, jstate = jssm.mlstm(jp, jnp.asarray(x, jnp.bfloat16), HEADS, chunk=16)
    got, state = ssm.mlstm(p, _t(x).to(torch.bfloat16), HEADS, chunk=16)
    assert got.dtype == torch.bfloat16 and state.c.dtype == torch.float32
    _close(got, np.asarray(want, np.float32), BF16_TOL)
    _close(state.c, jstate.c, BF16_TOL)


# ------------------------------------------------------------------ sLSTM

def test_slstm_and_step_match():
    jp, p = _params(jssm.slstm_init, D, HEADS)
    x = _rand(2, 20, D, seed=11)
    want, jstate = jssm.slstm(jp, jnp.asarray(x), HEADS)
    got, state = ssm.slstm(p, _t(x), HEADS)
    _close(got, want, TOL)
    for a, b in zip(state, jstate):
        _close(a, b, TOL)
    # from a given state: the pass, then two steps
    given = [_rand(2, HEADS, D // HEADS, seed=12 + i) for i in range(4)]
    given[2] = given[2] - 3.0                       # m: a running max of logs
    jgiven = jssm.SLSTMState(*map(jnp.asarray, given))
    tgiven = ssm.SLSTMState(*map(_t, given))
    want, jstate = jssm.slstm(jp, jnp.asarray(x[:, :5]), HEADS, state=jgiven)
    got, state = ssm.slstm(p, _t(x[:, :5]), HEADS, state=tgiven)
    _close(got, want, TOL)
    for i in range(2):
        xt = _rand(2, 1, D, seed=16 + i)
        want, jstate = jssm.slstm_step(jp, jnp.asarray(xt), jstate, HEADS)
        got, state = ssm.slstm_step(p, _t(xt), state, HEADS)
        _close(got, want, TOL)
        for a, b in zip(state, jstate):
            _close(a, b, TOL)


def test_slstm_zero_state():
    st = ssm.slstm_zero_state(3, D, HEADS, "cpu")
    want = jssm.slstm_zero_state(3, D, HEADS)
    for a, b in zip(st, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close(a, b, 0.0)
    assert float(st.m.max()) == -10.0


# -------------------------------------------------------------------- SSD

@pytest.mark.parametrize("t", [40, 16])
def test_ssd_and_step_match(t):
    jp, p = _params(jssm.ssd_init, D, HEADS, STATE)
    assert p["a_log"].dtype == p["d_skip"].dtype == torch.float32
    x = _rand(2, t, D, seed=18)
    want, jstate = jssm.ssd(jp, jnp.asarray(x), HEADS, STATE, chunk=16)
    got, state = ssm.ssd(p, _t(x), HEADS, STATE, chunk=16)
    assert tuple(state.h.shape) == (2, HEADS, STATE, D // HEADS)
    _close(got, want, CHUNK_TOL)
    _close(state.h, jstate.h, CHUNK_TOL)
    for i in range(2):
        xt = _rand(2, 1, D, seed=19 + i)
        want, jstate = jssm.ssd_step(jp, jnp.asarray(xt), jstate, HEADS, STATE)
        got, state = ssm.ssd_step(p, _t(xt), state, HEADS, STATE)
        _close(got, want, TOL)
        _close(state.h, jstate.h, TOL)


def test_ssd_matches_in_bf16():
    jp, p = _params(jssm.ssd_init, D, HEADS, STATE, dtype=jnp.bfloat16)
    assert p["a_log"].dtype == torch.float32 and p["w_x"].dtype == torch.bfloat16
    x = _rand(2, 40, D, seed=21)
    want, jstate = jssm.ssd(jp, jnp.asarray(x, jnp.bfloat16), HEADS, STATE, chunk=16)
    got, state = ssm.ssd(p, _t(x).to(torch.bfloat16), HEADS, STATE, chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_TOL)
    _close(state.h, jstate.h, BF16_TOL)


def test_softplus_matches_jax_across_its_threshold():
    """torch's softplus returns x above 20; JAX's is logaddexp(x, 0). In
    f32 the two agree within 1e-6 of max(1, |x|) from -40 to 60, the
    threshold included."""
    x = np.linspace(-40.0, 60.0, 20001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = F.softplus(torch.as_tensor(x)).numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * np.maximum(1.0, np.abs(x)))


@pytest.mark.parametrize("init,args", [
    ("mlstm_init", (D, HEADS)), ("slstm_init", (D, HEADS)), ("ssd_init", (D, HEADS, STATE))])
def test_inits_have_the_reference_layout(init, args):
    """The port's seeded init: the reference's keys, shapes and dtypes in
    bf16, the same numbers for the same seed."""
    jp = getattr(jssm, init)(jax.random.PRNGKey(0), *args, jnp.bfloat16)
    gen = torch.Generator().manual_seed(3)
    p = getattr(ssm, init)(gen, *args, torch.bfloat16, "cpu")
    again = getattr(ssm, init)(torch.Generator().manual_seed(3), *args, torch.bfloat16, "cpu")
    assert sorted(p) == sorted(jp)
    for key in jp:
        want_dtype = torch.float32 if jp[key].dtype == jnp.float32 else torch.bfloat16
        assert tuple(p[key].shape) == jp[key].shape and p[key].dtype == want_dtype, key
        assert torch.equal(p[key], again[key])
