"""Serving launcher: batched prefill + greedy decode with the KV cache
(counterpart of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --batch 4 --prompt-len 512 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --reduced --device cpu --batch 2 --prompt-len 32 --gen 4

Every architecture of the registry serves (``--arch``: zamba2-2.7b,
mamba2-2.7b, granite-3-2b, stablelm-3b, internlm2-20b, phi3-medium-14b,
chameleon-34b, arctic-480b, deepseek-v2-236b, whisper-medium).  The batch
of prompts is prefilled in ONE full-sequence pass with
``Variant.use_pallas`` set, so every attention layer (the hybrid's shared
sites; whisper's encoder, self- and cross-attention; deepseek's latent
attention, expanded) runs on the hand-written flash-attention kernel and
every Mamba layer's SSD on the hand-written SSD kernel; the first token
comes from the prefill's logits, and the other ``gen - 1`` are decoded
greedily from the cache (decode is plain PyTorch, as the reference computes
it outside any Pallas kernel).  Weights, prompts and whisper's frame
embeddings are random, drawn from ``--seed`` on the device.  The device
defaults to ``cuda`` and raises without one; ``--device cpu`` runs the
kernels' plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

#: the block both kernels' wrappers default to (``flash_attention`` q/kv
#: blocks); the SSD chunk is the config's
FLASH_BLOCK = 256


def check_prompt_len(cfg, prompt_len: int) -> None:
    """Raise unless the prompt length suits the prefill kernels' block
    rules: the flash wrapper's ``Sq % min(256, Sq) == 0`` and, where the
    model has SSM layers, the SSD's ``S % min(chunk, S) == 0`` (so P <= 256
    or P % 256 == 0 at chunk 256)."""
    blocks = [("flash-attention block", FLASH_BLOCK)]
    if cfg.ssm is not None:
        blocks.append(("SSD chunk", cfg.ssm.chunk_size))
    for what, block in blocks:
        if prompt_len < 1 or prompt_len % min(block, prompt_len):
            raise ValueError(
                f"--prompt-len {prompt_len} is not a multiple of the "
                f"{what} {block}: the prefill kernels need a prompt length "
                f"<= {block} or a multiple of it")


def pad_cache(cfg, cache: dict, batch: int, prompt_len: int,
              extra: int) -> dict:
    """The prefill's cache with room for ``extra`` more tokens: every entry
    whose shape grows with the sequence (``init_cache``'s shapes at
    ``prompt_len`` against ``prompt_len + extra``: k/v, mla's c and k_rope)
    is padded with zeros on that axis; the others (an SSM layer's state and
    conv windows, encdec's xk/xv over the encoder frames) stay as they
    are."""
    import torch.nn.functional as F

    from repro_torch.models.registry import cache_shapes

    def pad(t, now, want):
        if isinstance(t, dict):
            return {k: pad(t[k], now[k], want[k]) for k in t}
        grown = [i for i, (a, b) in enumerate(zip(now[0], want[0])) if a != b]
        if not grown:
            return t
        (axis,) = grown
        return F.pad(t, (0, 0) * (t.ndim - 1 - axis) + (0, extra))
    return pad(cache, cache_shapes(cfg, batch, prompt_len),
               cache_shapes(cfg, batch, prompt_len + extra))


def run(cfg, *, batch: int, prompt_len: int, gen: int, seed: int,
        device) -> dict:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens through the
    kernels, then decode ``gen - 1`` tokens greedily.  Returns the generated
    tokens (batch, gen), the prefill and decode seconds and the number of
    decode steps."""
    import torch

    from repro_torch.distributed.sharding import make_smoke_ctx
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build, make_batch
    from repro_torch.models.variant import BASELINE

    check_prompt_len(cfg, prompt_len)
    if gen < 1:
        raise ValueError(f"--gen must be >= 1, got {gen}")
    model = build(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator(device=device).manual_seed(seed))
    inputs = make_batch(cfg, (batch, prompt_len), torch.Generator(
        device=device).manual_seed(seed + 1))
    # encdec's prefill takes the batch (tokens and frames), the others the
    # tokens
    prompt = inputs if cfg.family == "encdec" else inputs["tokens"]
    variant = replace(BASELINE, use_pallas=True)
    ctx = make_smoke_ctx()
    V = cfg.vocab_size

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, ctx, variant)
        sync()
        prefill_s = time.perf_counter() - t0
        # room for the generated tokens, zeros as init_cache makes them
        cache = pad_cache(cfg, cache, batch, prompt_len, gen)
        toks = torch.argmax(logits[:, :V], dim=-1)[:, None]
        out = [toks]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, cache = model.decode_step(params, cache, toks,
                                              prompt_len + i, ctx, variant)
            toks = torch.argmax(logits[:, :, :V], dim=-1)
            out.append(toks)
        sync()
        decode_s = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1).tolist(), "prefill_s": prefill_s,
            "decode_s": decode_s, "decode_steps": gen - 1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu "
                         "(the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    B, P, G = args.batch, args.prompt_len, args.gen
    r = run(cfg, batch=B, prompt_len=P, gen=G, seed=args.seed, device=device)
    n_steps, dt = r["decode_steps"], r["decode_s"]
    print(f"arch={cfg.name} batch={B} prompt={P} gen={G}")
    print(f"sample continuation (seq 0): {r['tokens'][0]}")
    if n_steps:
        print(f"decode throughput: {B * n_steps / dt:.1f} tok/s "
              f"({dt / n_steps * 1e3:.1f} ms/step @ batch {B})")
    else:
        print(f"decode throughput: no decode step (gen={G})")
    print(f"prefill: {r['prefill_s'] * 1e3:.1f} ms for {B * P} tokens "
          f"({B * P / r['prefill_s']:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
