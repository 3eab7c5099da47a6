#!/usr/bin/env python3
"""How far one decode step's hidden states and logits move, layer by layer,
when the int8 decode attention changes by about one bfloat16 ulp.

For each model of ``chip_smoke.FAMILIES`` that has attention (qwen3-1.7b and
zamba2-1.2b whole, dbrx-132b cut to 2 layers; bf16, int8 KV cache, seeded
weights) it
admits ``chip_smoke.py``'s ``serve_families`` requests through
``ServeEngine``, then runs the first decode step from that state four
times, layer by layer: with K11, with its plain version, and twice with the
plain version's outputs multiplied by ``1 + 2^-9 · N(0, 1)`` (half a
bfloat16 ulp, two seeds).  It prints one JSON line a model: for every layer
the largest |difference| of the residual stream over its largest |value|
(K11 against plain, noise against plain, noise against noise), the same
for the logits, the argmax agreement and the largest |score| of a valid
cache slot.  Then the card's name and power limit.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 experiments/torch_lm_step_divergence.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import chip_smoke as C  # noqa: E402

#: relative noise put on the plain attention's outputs: half a bfloat16 ulp
STEP_NOISE = 2.0 ** -9


def admitted(arch, layers, slots, max_len, prompts, max_new, dispatch):
    """Params, config and the engine after admitting ``serve_families``'s
    requests for this model (its prompts from ``FAMILY_SEED``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    cfg = get_config(arch).replace(kv_quant=True)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if dispatch is not None:
        cfg = cfg.replace(moe_dispatch=dispatch)
    dev = torch.device("cuda")
    params = M.init(cfg, torch.Generator(device=dev).manual_seed(
        C.FAMILY_SEED), device=dev)
    eng = ServeEngine(params, cfg, max_batch=slots, max_len=max_len,
                      device=dev)
    lens, rng = C.family_prompt_lengths(arch)
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   max_new_tokens=max_new)
    eng._admit()
    return params, cfg, eng


def step_by_layer(params, cfg, eng, attend, scores):
    """One decode step from the engine's state (on a copy of its caches),
    with ``attend`` as the int8 decode attention; the residual stream after
    every layer (float32) and the logits."""
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.models import attention as A
    from repro_torch.models import blocks, layers, model as M

    def traced(*a, **kw):
        scores.append(C.k11_oracle_f64(a, kw.get("window"),
                                       kw.get("softcap", 0.0))[1])
        return attend(*a, **kw)

    dev = torch.device("cuda")
    caches = C.clone_caches(eng.caches)
    toks = torch.from_numpy(eng.last_tokens.copy()).long().to(dev)
    pos = torch.from_numpy(eng.lengths.copy()).to(dev)
    A.decode_attention_int8 = traced
    xs = []
    try:
        with torch.no_grad():
            x = layers.embed_tokens(params["embed"], toks, cfg)
            x = x * layers.embed_scale(cfg.d_model, x.dtype).to(dev)
            for i, kind in enumerate(M.layer_kinds(cfg)):
                x, _, _ = blocks.block_apply(
                    kind, cfg, params["layers"][i], x,
                    shared_params=params.get("shared"),
                    cache=caches["layers"][i], cache_len=pos)
                xs.append(x.float())
            x = layers.rms_norm(params["final_norm"], x, cfg.norm_eps)
            logits = layers.lm_head_apply(params.get("head"),
                                          params["embed"], x, cfg).float()
    finally:
        A.decode_attention_int8 = K11.decode_attention_int8
    return xs, logits


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_lm_step_divergence: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as K11
    from repro_torch.models import model as M
    build.build_all(("decode_attention_int8",))
    build.load("decode_attention_int8")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def noisy(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def attend(*a, **kw):
            out = K11.decode_attention_int8_plain(*a, **kw)
            return (out.float() * (1 + STEP_NOISE * torch.randn(
                out.shape, generator=gen, device="cuda"))).to(out.dtype)
        return attend

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for family in C.FAMILIES:
        params, cfg, eng = admitted(*family[:7])
        kinds = M.layer_kinds(cfg)
        if not any("attn" in c for c in eng.caches["layers"]):
            continue
        scores = []
        runs = {name: step_by_layer(params, cfg, eng, fn, scores)
                for name, fn in (("kernel", K11.decode_attention_int8),
                                 ("plain", K11.decode_attention_int8_plain),
                                 ("noise", noisy(1)), ("noise2", noisy(2)))}
        pairs = (("kernel", "plain"), ("noise", "plain"),
                 ("noise2", "noise"))
        print(json.dumps({
            "arch": family[0], "n_layers": cfg.n_layers,
            "noise": STEP_NOISE, "max_abs_score": max(scores),
            "layers": [{"layer": i, "kind": kinds[i],
                        "max_abs_x": float(runs["plain"][0][i].abs().max()),
                        **{f"{a}_vs_{b}": rel(runs[a][0][i], runs[b][0][i])
                           for a, b in pairs}}
                       for i in range(len(kinds))],
            "logits": {f"{a}_vs_{b}": rel(runs[a][1], runs[b][1])
                       for a, b in pairs},
            "argmax_agree": {f"{a}_vs_{b}": float(
                (runs[a][1].argmax(-1) == runs[b][1].argmax(-1))
                .float().mean()) for a, b in pairs}}), flush=True)
        del params, eng, runs
        torch.cuda.empty_cache()
    print(C.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
