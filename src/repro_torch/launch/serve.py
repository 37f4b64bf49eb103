"""Serving launcher: batched prefill + greedy decode (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
        --reduced --device cpu --batch 4 --prompt-len 32 --gen 16

Without ``--device`` it runs on the CUDA card, and raises without one.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.tokens import make_batch
from repro_torch.device import generator, resolve_device
from repro_torch.models import lm


def serve(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
          gen: int) -> torch.Tensor:
    """Greedy generation of ``gen`` tokens after the prompt ``tokens``
    (B, S): one prefill, then ``gen - 1`` decode steps. The ids stay on the
    device until the end; the host reads them once, as a (B, gen) int32
    CPU tensor."""
    B, S = tokens.shape
    logits, caches = lm.prefill(params, cfg, {"tokens": tokens},
                                max_len=S + gen)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    out = [tok]
    for i in range(gen - 1):
        pos = torch.full((B,), S + i, dtype=torch.int32,
                         device=tokens.device)
        logits, caches = lm.decode_step(params, cfg, tok[:, None], pos, caches)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1).cpu()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    shape = InputShape("cli_prompt", args.prompt_len, args.batch, "prefill")
    with torch.inference_mode():
        params = lm.init_params(cfg, generator(dev, args.seed), dev)
        tokens = make_batch(cfg, shape, args.seed, device=dev)["tokens"]
        t0 = time.perf_counter()
        ids = serve(cfg, params, tokens, args.gen)
        dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={dev} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"generated token ids (first row): {ids[0].tolist()}")
    print(f"wall {dt:.2f}s  ({args.batch * args.gen / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
