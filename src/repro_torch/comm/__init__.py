"""Uplink compression codecs of the port (``identity`` and ``stoch_quant``)."""

from repro_torch.comm.codecs import (
    Codec,
    IdentityCodec,
    StochQuantCodec,
    build_codec,
    codec_names,
    normalize_spec,
)

__all__ = [
    "Codec",
    "IdentityCodec",
    "StochQuantCodec",
    "build_codec",
    "codec_names",
    "normalize_spec",
]
