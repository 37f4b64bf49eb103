from repro_torch.kernels.stoch_quant.ops import quantize_with_uniforms, stoch_quant
from repro_torch.kernels.stoch_quant.ref import stoch_quant_ref
