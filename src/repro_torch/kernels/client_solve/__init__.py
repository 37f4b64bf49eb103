from repro_torch.kernels.client_solve.ops import client_solve
from repro_torch.kernels.client_solve.ref import client_solve_plain, client_solve_ref
