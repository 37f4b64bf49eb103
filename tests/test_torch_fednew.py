"""The port's FedNew slice against the JAX package, on the CPU.

Data are built by the JAX package and handed over as numpy. The kernel
route is compared with JAX's ``backend="pallas"`` (its kernels in interpret
mode; the port runs the kernels' plain versions on the CPU), the
``reference`` routes with each other (Cholesky and the plain quantizer).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ALPHA, ORACLE, RHO, TRAJ, replay_uniforms, small_problem, t
from repro.comm import codecs as jax_codecs
from repro.core import engine as jax_engine
from repro.core import fednew as jax_fednew
from repro.core import quantization as jax_quant
from repro_torch import convert
from repro_torch.core import engine, fednew, quantization

ROUTES = {"kernel": "pallas", "reference": "reference"}  # port -> JAX backend
ROUNDS = 20


@pytest.fixture(scope="module")
def problem():
    return small_problem()


def _cfgs(route, **kw):
    hp = dict(rho=RHO, alpha=ALPHA, **kw)
    return (fednew.FedNewConfig(backend=route, **hp),
            jax_fednew.FedNewConfig(backend=ROUTES[route], **hp))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **tol)


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------


def test_logreg_oracles_match(problem):
    jobj, jdata, tobj, tdata = problem
    x = np.random.default_rng(0).standard_normal(tdata.dim).astype(np.float32)
    xt = torch.from_numpy(x)
    for oracle in ("local_loss", "local_grad", "local_hessian"):
        got = getattr(tobj, oracle)(xt, tdata)
        want = getattr(jobj, oracle)(jnp.asarray(x), jdata)
        _close(got, want, **ORACLE)
    _close(tobj.global_loss(xt, tdata), jobj.global_loss(jnp.asarray(x), jdata),
           **ORACLE)
    _close(tobj.global_grad(xt, tdata), jobj.global_grad(jnp.asarray(x), jdata),
           **ORACLE)


# ---------------------------------------------------------------------------
# exact bit ledger
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [1, 3, 8])
@pytest.mark.parametrize("d", [20, 267, 10**9])
def test_payload_bits_equal_jax(bits, d):
    assert quantization.payload_bits(bits, d) == jax_quant.payload_bits(bits, d)
    assert quantization.exact_payload_bits(d, 32) == jax_quant.exact_payload_bits(d, 32)
    assert quantization.word_bits(torch.float32) == jax_quant.word_bits(jnp.float32)


@pytest.mark.parametrize("name,hp,want", [
    ("fednew", {}, 32 * 267),
    ("q-fednew", {"bits": 3}, 3 * 267 + 32),
])
def test_solver_ledger_equals_jax(name, hp, want):
    """FedNew 32·d = 8544, Q-FedNew(3b) 3·d + 32 = 833 at w8a's d = 267,
    uplink and downlink, integer for integer."""
    hp = dict(rho=RHO, alpha=ALPHA, **hp)
    got = engine.solver_ledger(name, **hp)
    ref = jax_engine.solver_ledger(name, **hp)
    for r in range(3):
        assert got.uplink(267, 32, r) == ref.uplink(267, 32, r) == want
        assert got.downlink(267, 32, r) == ref.downlink(267, 32, r) == 32 * 267
    codec = fednew.FedNewConfig(**hp).build_codec()
    metric = codec.payload_bits_metric(267, 32, torch.device("cpu"))
    assert metric.dtype == torch.int64 and metric.item() == want


def test_registry_rejects_bad_solvers():
    with pytest.raises(KeyError):
        engine.get_solver("fedgd")
    with pytest.raises(ValueError):
        engine.get_solver("q-fednew", rho=RHO)
    with pytest.raises(TypeError):
        engine.get_solver("fednew", solve_backend="pallas")
    assert engine.get_solver("q-fednew", bits=3).name == "q-fednew(3b)"


# ---------------------------------------------------------------------------
# slice parity: whole trajectories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["kernel", "reference"])
@pytest.mark.parametrize("hessian_period", [1, 0])
def test_fednew_trajectory_matches_jax(problem, route, hessian_period):
    """20 FedNew rounds through each side's engine (host mode)."""
    jobj, jdata, tobj, tdata = problem
    tcfg, jcfg = _cfgs(route, hessian_period=hessian_period)
    _, jm = jax_fednew.run(jobj, jdata, jcfg, ROUNDS)
    _, tm = fednew.run(tobj, tdata, tcfg, ROUNDS)
    for field in ("loss", "grad_norm", "direction_norm"):
        _close(getattr(tm, field), getattr(jm, field), **TRAJ)
    assert tm.uplink_bits_per_client.tolist() == [32 * tdata.dim] * ROUNDS
    assert np.asarray(jm.uplink_bits_per_client).tolist() == [32 * tdata.dim] * ROUNDS
    assert float(jm.loss[-1]) < float(jm.loss[0])


@pytest.mark.parametrize("route", ["kernel", "reference"])
def test_qfednew_trajectory_with_jax_uniforms(problem, route, monkeypatch):
    """20 Q-FedNew(3b) rounds; each round the port's step takes the uniforms
    JAX draws from its key schedule. The loss agrees at rtol 1e-4 in every
    round, and in every round the port's quantizer, given the JAX round's
    own inputs (directions, ŷ, uniforms), emits JAX's levels exactly.

    The levels of the two trajectories are not compared entry by entry: the
    quantizer's feedback (R = max|y - ŷ| sets every level's step) amplifies
    the frameworks' last-bit differences in y_i by about 1.5x per round, so
    after ~15 rounds c straddles a uniform in a few entries and the runs
    part by a level. JAX's own pallas and reference routes part the same
    way on this problem (94.6% of 1,600 levels equal after 20 rounds)."""
    jobj, jdata, tobj, tdata = problem
    tcfg, jcfg = _cfgs(route, bits=3)
    encoded = []
    orig = jax_codecs.StochQuantCodec.encode

    def recording_encode(self, keys, y, state, step):
        wire = orig(self, keys, y, state, step)
        encoded.append((np.asarray(y), np.asarray(state),
                        np.asarray(wire["levels"])))
        return wire

    monkeypatch.setattr(jax_codecs.StochQuantCodec, "encode", recording_encode)
    port_codec = tcfg.build_codec()

    key = jax.random.PRNGKey(0)
    jstate = jax_fednew.init(jobj, jdata, jcfg, key)
    tstate = fednew.init(tobj, tdata, tcfg)
    n, d = tdata.n_clients, tdata.dim
    j_loss, t_loss = [], []
    for _ in range(ROUNDS):
        key, u = replay_uniforms(key, n, d)
        jstate, jm = jax_fednew.step(jstate, jobj, jdata, jcfg)
        u_t = convert.uniforms_from_numpy(u, device="cpu")
        tstate, tm = fednew.step(tstate, tobj, tdata, tcfg, uniforms=u_t)
        j_loss.append(float(jm.loss))
        t_loss.append(tm.loss.item())
        assert tm.uplink_bits_per_client.item() == 3 * d + 32
        assert float(jm.uplink_bits_per_client) == 3 * d + 32
        y, state, levels = encoded[-1]
        wire = port_codec.encode(u_t, t(y), t(state))
        np.testing.assert_array_equal(wire["levels"].numpy(), levels)
    assert len(encoded) == ROUNDS
    np.testing.assert_array_equal(np.asarray(jstate.key), np.asarray(key))
    _close(t_loss, j_loss, rtol=1e-4, atol=0)


@pytest.mark.parametrize("route", ["kernel", "reference"])
def test_jax_state_carries_over(problem, route):
    """A JAX state after 5 rounds, converted, runs 5 more rounds in the port
    and matches the JAX run at rounds 6-10. hessian_period=0 keeps the
    carried curvature (raw H on the kernel route, Cholesky factors on the
    reference route) in use for every round."""
    jobj, jdata, tobj, tdata = problem
    tcfg, jcfg = _cfgs(route, hessian_period=0)
    jsolver = jax_fednew.solver(jcfg)
    jstate, _ = jax_engine.run(jsolver, jobj, jdata, 5, mode="host")
    _, jm = jax_engine.run(jsolver, jobj, jdata, 10, mode="host")
    state = convert.fednew_state_from_numpy(
        *(np.asarray(getattr(jstate, f)) for f in ("x", "y", "lam", "curv", "comm")),
        int(jstate.step), device="cpu",
    )
    losses = []
    for _ in range(5):
        state, m = fednew.step(state, tobj, tdata, tcfg)
        losses.append(m.loss.item())
    assert state.step == 10
    _close(losses, jm.loss[5:], **TRAJ)


def test_step_draws_uniforms_from_its_generator(problem):
    """Without injected uniforms Q-FedNew draws from the state's seeded
    generator: the same seed gives the same run, another seed another."""
    _, _, tobj, tdata = problem
    solver = engine.get_solver("q-fednew", rho=RHO, alpha=ALPHA, bits=3)
    _, a = engine.run(solver, tobj, tdata, 5, seed=1)
    _, b = engine.run(solver, tobj, tdata, 5, seed=1)
    _, c = engine.run(solver, tobj, tdata, 5, seed=2)
    assert torch.equal(a.loss, b.loss)
    assert not torch.equal(a.loss, c.loss)
