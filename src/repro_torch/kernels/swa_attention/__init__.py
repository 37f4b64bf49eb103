from repro_torch.kernels.swa_attention.ops import swa_attention
from repro_torch.kernels.swa_attention.ref import swa_attention_plain, swa_attention_ref
