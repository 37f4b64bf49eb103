"""Federated execution engine of the port: the solver protocol, the
registry and the host driver.

Counterpart of ``repro.core.engine``'s ``mode="host"``: one Python loop
over rounds, each round one ``step`` that enqueues its work on the
device. Metrics stay on the device while the loop runs; they are stacked
and read to the host once, at the end. Scan blocks (here: CUDA graphs of a
block of rounds), client sharding and participation wait for later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.core.objectives import ClientDataset, Objective


@dataclasses.dataclass(frozen=True)
class FederatedSolver:
    """The math of one federated method.

    init(obj, data, seed=0) -> state            round-0 state (x = 0) on the
                                                data's device
    step(state, obj, data) -> (state, metrics)  one outer round; metrics is
                                                a NamedTuple of scalar
                                                device tensors
    client_fields   names of state fields with a leading client axis
    """

    name: str
    init: Callable[..., Any]
    step: Callable[..., Tuple[Any, Any]]
    client_fields: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class SolverLedger:
    """Exact per-message communication accounting for one configured
    solver: ``uplink(d, word, round_index)`` / ``downlink(...)`` are the
    bits ONE client sends/receives in a round, as exact Python ints."""

    uplink: Callable[[int, int, int], int]
    downlink: Callable[[int, int, int], int]


def _registry() -> dict:
    from repro_torch.core import fednew

    return {
        "fednew": (fednew.solver, fednew.ledger, fednew.FedNewConfig),
        "q-fednew": (fednew.solver, fednew.ledger, fednew.FedNewConfig),
    }


def solver_names() -> tuple:
    return tuple(sorted(_registry()))


def _config(name: str, hparams: dict):
    """The registry row of ``name`` and its validated config."""
    reg = _registry()
    if name not in reg:
        raise KeyError(
            f"unknown solver {name!r}; registered: {', '.join(solver_names())}"
        )
    cfg_cls = reg[name][2]
    valid = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = sorted(set(hparams) - valid)
    if unknown:
        raise TypeError(
            f"solver {name!r} got unknown hparam(s) {unknown}; valid hparams: "
            f"{sorted(valid)}"
        )
    if name == "q-fednew" and not hparams.get("bits"):
        raise ValueError("q-fednew requires bits=<int>")
    return reg[name], cfg_cls(**hparams)


def get_solver(name: str, **hparams) -> FederatedSolver:
    """``fednew`` / ``q-fednew`` (needs ``bits``); ``hparams`` feed
    ``FedNewConfig`` (e.g. ``rho=0.1, alpha=0.03, hessian_period=1``)."""
    (factory, _, _), cfg = _config(name, hparams)
    return factory(cfg)


def solver_ledger(name: str, **hparams) -> SolverLedger:
    """Exact bit accounting for a configured solver, by registry name."""
    (_, ledger, _), cfg = _config(name, hparams)
    return ledger(cfg)


def run(solver: FederatedSolver, obj: Objective, data: ClientDataset,
        rounds: int, *, seed: int = 0):
    """Run ``rounds`` rounds in the host loop; returns ``(final_state,
    metrics)`` with every metric stacked to shape ``(rounds,)`` on the host."""
    if rounds <= 0:
        raise ValueError("rounds must be positive")
    state = solver.init(obj, data, seed)
    history = []
    for _ in range(rounds):
        state, m = solver.step(state, obj, data)
        history.append(m)
    cls = type(history[0])
    stacked = [torch.stack(vals) for vals in zip(*history)]
    # one host read of all metrics, after the last round
    host = torch.cat([t.to(torch.float64) for t in stacked]).cpu()
    fields = []
    for i, t in enumerate(stacked):
        fields.append(host[i * rounds:(i + 1) * rounds].to(t.dtype))
    return state, cls(*fields)
