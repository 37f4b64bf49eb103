"""Uplink compression codecs: ``identity`` (FedNew) and ``stoch_quant``
(Q-FedNew).

Counterpart of ``repro.comm.codecs`` for the two codecs of the main path.
One round is encode -> decode -> update_state, batched over a leading
client axis:

  init_state(n, d, dtype, device)  per-client codec memory, ``(n, width)``:
                                   the previous quantized vector ŷ for
                                   stoch_quant, nothing for identity
  encode(u, y, state) -> wire      client side; ``u`` is the round's
                                   ``(n, d)`` uniforms (``None`` for a codec
                                   without randomness)
  decode(wire, state) -> y_tx      server-side reconstruction, computed once
                                   per round and also fed to
                                   ``update_state``, so client and server
                                   hold the same view by construction
  update_state(y_tx, y, state)     client-side state advance
  payload_bits(d, word, round)     exact Python-int uplink bits per message
  payload_bits_metric(d, word, device)  the same count as an int64 tensor
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch

from repro_torch.core import quantization
from repro_torch.core.quantization import (
    exact_payload_bits,
    payload_bits,
    payload_bits_array,
)
from repro_torch.kernels import dispatch
from repro_torch.kernels.stoch_quant.ops import quantize_with_uniforms

Wire = Dict[str, torch.Tensor]
CodecSpec = Union[str, Mapping[str, Any], "Codec"]


class Codec:
    """Base codec: full precision on the wire, no state, no randomness."""

    name = "identity"
    needs_rng = False  # True => the solver draws uniforms every round

    def __init__(self, backend: str = "auto"):
        del backend  # registry uniformity; the base codec has no kernel

    def spec(self) -> Dict[str, Any]:
        """JSON-able ``{"name": ..., **params}`` that rebuilds this codec."""
        return {"name": self.name}

    def state_width(self, d: int) -> int:
        return 0

    def init_state(self, n_clients: int, d: int, dtype, device) -> torch.Tensor:
        return torch.zeros((n_clients, self.state_width(d)), dtype=dtype,
                           device=device)

    def payload_bits(self, d: int, word: int, round_index: int = 0) -> int:
        """Exact Python-int uplink bits for ONE client's message."""
        return exact_payload_bits(d, word)

    def payload_bits_metric(self, d: int, word: int, device) -> torch.Tensor:
        """The per-round metric: the exact count as an int64 tensor."""
        return payload_bits_array(self.payload_bits(d, word), device)

    def encode(self, u: Optional[torch.Tensor], y: torch.Tensor,
               state: torch.Tensor) -> Wire:
        del u, state
        return {"values": y}

    def decode(self, wire: Wire, state: torch.Tensor) -> torch.Tensor:
        del state
        return wire["values"]

    def update_state(self, y_tx: torch.Tensor, y: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
        del y_tx, y
        return state


class IdentityCodec(Codec):
    """Full precision on the wire: ``word·d`` bits per message."""


class StochQuantCodec(Codec):
    """Paper eqs. 25-30 stochastic quantization of ``y - state`` (``state``
    is the previously quantized vector ŷ).

    On the kernel route (backend ``auto``/``kernel``) the levels come from
    the stoch_quant kernel wrapper; on ``reference`` from the plain
    ``core.quantization.quantize``. The wire is ``(levels, R)``: integer
    levels plus the per-client range, ``bits·d + 32`` bits. ``decode``
    rebuilds ŷ with the eq. 30 expression of :func:`_dequantize`.
    """

    name = "stoch_quant"
    needs_rng = True

    def __init__(self, bits: int, backend: str = "auto"):
        if not isinstance(bits, int) or isinstance(bits, bool) or bits < 1:
            raise ValueError(
                f"stoch_quant bits must be a positive int, got {bits!r}"
            )
        self.bits = bits
        self.backend = dispatch.validate_backend(backend)

    def spec(self) -> Dict[str, Any]:
        return {"name": self.name, "bits": self.bits}

    def state_width(self, d: int) -> int:
        return d

    def payload_bits(self, d: int, word: int, round_index: int = 0) -> int:
        del word, round_index  # quantized words; R accounted at R_BITS
        return payload_bits(self.bits, d)

    def encode(self, u, y, state):
        # The range R is transmitted; delta derives from it on both ends.
        if dispatch.uses_kernel(self.backend):
            levels, R = quantize_with_uniforms(u, y, state, self.bits)
        else:
            levels = quantization.quantize(u, y, state, self.bits).levels
            R = torch.amax(torch.abs(y - state), dim=-1)
        return {"levels": levels, "range": R}

    def decode(self, wire, state):
        return _dequantize(wire["levels"], wire["range"], state, self.bits)

    def update_state(self, y_tx, y, state):
        del y, state
        return y_tx  # the reconstruction IS the next round's ŷ


def _dequantize(levels, R, state, bits: int) -> torch.Tensor:
    """Eq. 30 with the reference's expression: ŷ = ŷ_prev + Δ·q - R."""
    delta = quantization.step_size(R, bits)
    return state + delta[:, None] * levels.to(state.dtype) - R[:, None]


_REGISTRY: Dict[str, type] = {
    "identity": IdentityCodec,
    "stoch_quant": StochQuantCodec,
}


def codec_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def normalize_spec(spec: CodecSpec) -> Dict[str, Any]:
    """Canonical dict form of a codec spec (validates the name)."""
    if isinstance(spec, Codec):
        return spec.spec()
    if isinstance(spec, str):
        out: Dict[str, Any] = {"name": spec}
    elif isinstance(spec, Mapping):
        out = dict(spec)
    else:
        raise ValueError(
            f"codec spec must be a name, a {{'name': ...}} mapping, or a "
            f"Codec, got {type(spec).__name__}"
        )
    if out.get("name") not in _REGISTRY:
        raise ValueError(
            f"unknown codec {out.get('name')!r}; registered codecs: "
            f"{', '.join(codec_names())}"
        )
    return out


def build_codec(spec: CodecSpec, *, backend: str = "auto") -> Codec:
    """Build a codec from its spec; unknown names or params raise
    ``ValueError``."""
    if isinstance(spec, Codec):
        return spec
    norm = normalize_spec(spec)
    cls = _REGISTRY[norm.pop("name")]
    try:
        return cls(**norm, backend=backend)
    except TypeError as e:
        raise ValueError(f"bad params for codec {cls.name!r}: {e}") from None
