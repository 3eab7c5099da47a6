"""Port vs reference: the continuous-batching serving engine gives the JAX
engine's tokens on the smoke configs (float32, int8 KV cache on and off) —
attention, MoE (its config's capacity: the ELL dispatch drops what the
reference drops), Mamba-2 with zamba2's shared block, and xLSTM, whose
recurrent caches a slot's admission replaces whole — and the port's serving
launcher runs on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.serve import ServeEngine as RServeEngine
from repro_torch.serve import ServeEngine
from test_torch_lm import ROOT, both_params, configs


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "h2o-danube-1.8b",
                                  "dbrx-132b", "mixtral-8x22b",
                                  "zamba2-1.2b", "xlstm-1.3b"])
def test_serve_engine_gives_the_references_tokens(arch, quant):
    """Five requests through three slots (continuous batching: two wait,
    slots free and refill); the smoke window (32) of h2o-danube and
    mixtral is shorter than two of the prompts, so their ring caches fill by
    the ring path and wrap."""
    rcfg, tcfg = configs(arch, kv_quant=quant)
    rp, tp = both_params(rcfg, tcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, tcfg.vocab_size, n).astype(np.int32)
               for n in (5, 20, 40, 9, 33)]
    ref = RServeEngine(rp, rcfg, max_batch=3, max_len=64)
    eng = ServeEngine(tp, tcfg, max_batch=3, max_len=64, device="cpu")
    for i, prompt in enumerate(prompts):
        ref.submit(prompt, max_new_tokens=8 + i)
        eng.submit(prompt, max_new_tokens=8 + i)
    want, got = ref.run(), eng.run()
    assert sorted(got) == sorted(want) == list(range(5))
    for rid in want:
        assert got[rid].done
        assert got[rid].generated == want[rid].generated, rid
    np.testing.assert_array_equal(eng.lengths, ref.lengths)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-1.2b"])
def test_serve_launcher_runs_on_the_cpu(arch):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         arch, "--scale", "smoke", "--kv-quant", "--device", "cpu",
         "--requests", "3", "--slots", "2", "--max-new", "4"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert "served 3 requests, 12 tokens" in out.stdout
    assert "on cpu" in out.stdout
