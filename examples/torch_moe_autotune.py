"""The paper's decision rule inside an MoE LM on the PyTorch/CUDA port:
dispatch-format auto-tuning.

Shows D_mat (= sigma/mu of tokens-per-expert) computed per step on the
device and the selection between ELL (capacity) and CSR (dropless)
dispatch — run-time data transformation.  Where the reference's branch is
a ``lax.cond`` inside one compiled program, the port's ``"auto"`` dispatch
reads ``D_mat < D*`` back to the host once per MoE layer and call, and runs
only the chosen branch (``models/moe.py:moe_apply``).

The port of ``examples/moe_autotune.py``, step for step.

    PYTHONPATH=src python examples/torch_moe_autotune.py
    PYTHONPATH=src python examples/torch_moe_autotune.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import forward, init
from repro_torch.models.moe import DEFAULT_D_STAR, dispatch_d_mat, route


def config():
    return smoke_config(get_config("mixtral-8x22b")).replace(
        moe_dispatch="auto", capacity_factor=1.25)


def inputs(cfg, seed=0):
    """The reference's numpy inputs: a (4, 64) batch of tokens and the
    (4 * 64, d_model) activations the router is shown."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64))
    x = rng.normal(size=(4 * 64, cfg.d_model)).astype(np.float32)
    return tokens, x


def inspect(params, cfg, tokens, x, device):
    """The routing statistics the rule sees on the first MoE layer, then a
    forward through the auto dispatch; returns D_mat, the branch, the
    logits and the load-balance loss."""
    moe_params = params["layers"][0]["moe"]
    ids, gw, aux = route(moe_params, torch.as_tensor(x, device=device), cfg)
    d_mat = float(dispatch_d_mat(ids, cfg.n_experts))
    branch = "ell" if d_mat < DEFAULT_D_STAR else "csr"
    print(f"tokens-per-expert D_mat = {d_mat:.3f} -> "
          f"{'ELL (capacity)' if branch == 'ell' else 'CSR (dropless)'}")

    batch = {"tokens": torch.as_tensor(tokens, device=device)}
    with torch.no_grad():
        logits, aux = forward(params, batch, cfg)
    print(f"forward through auto-dispatch ok: logits "
          f"{tuple(logits.shape)}, load-balance aux={float(aux):.4f}")
    return {"d_mat": d_mat, "branch": branch, "logits": logits,
            "aux": float(aux)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = config()
    params = init(cfg, torch.Generator(device=device).manual_seed(0),
                  device=device)
    print(f"arch={cfg.name} experts={cfg.n_experts} top_k={cfg.top_k} "
          f"dispatch=auto (D*={DEFAULT_D_STAR})")
    tokens, x = inputs(cfg)
    out = inspect(params, cfg, tokens, x, device)
    out["logits"] = tuple(out["logits"].shape)
    return out


if __name__ == "__main__":
    main()
