"""Fault-tolerant training loop.

The port of the JAX package's ``train/loop.py``:

  * periodic async checkpoints (atomic; latest-K kept), written in the
    reference's layout and format, so either package resumes the other's;
  * ``run_with_restarts``: any step failure (injected or real) restores the
    latest committed checkpoint and resumes — the data pipeline is
    seekable, so the resumed trajectory is the uninterrupted one;
  * step-time watchdog: an EMA of step latency flags stragglers;
  * metrics per step.

The state is float32 masters and AdamW moments on the trainer's device;
each step overwrites them in place (``make_train_step(inplace=True)``).
With ``TrainConfig.mixed_precision`` the model runs on bfloat16 working
parameters and the float32 masters live in the optimizer state
(``AdamWMixedState``), which each step updates in place.

Under a ``mesh`` (``launch/mesh.py``) every rank of it runs the trainer in
step: the state is DTensors placed by the cell's shardings
(``launch/steps.py:jitted_step_for_cell``), each rank reads the same
global batch from the seekable pipeline and takes its shard, and a
checkpoint gathers the state whole (rank 0 writes) and is placed again on
restore.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint import AsyncCheckpointer, latest_step, restore
from ..configs.base import ModelConfig, ShapeConfig
from ..data import Prefetcher, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import model as M
from ..models.convert import (jax_spec, opt_state_from_jax,
                              opt_state_to_jax, params_from_jax,
                              params_to_jax)
from ..optim import adamw
from ..sharding.rules import tree_map


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep_ckpts: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0   # step > factor * EMA -> flagged
    microbatches: int = 1
    mixed_precision: bool = False   # bf16 working params, f32 master in opt
    seed: int = 0


@dataclass
class TrainState:
    params: Any
    opt_state: Any              # adamw.AdamWState or AdamWMixedState
    step: int = 0


class StragglerWatchdog:
    def __init__(self, factor: float):
        self.factor = factor
        self.ema: Optional[float] = None
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.flagged.append(step)
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return slow


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """A host batch on ``device``: token ids as int64 (torch indexes and
    gathers with them), frontend embeddings as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if k in ("tokens", "labels"):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


class Trainer:
    def __init__(self, cfg: ModelConfig, data: SyntheticLM,
                 tc: TrainConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 failure_hook: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = None, mesh: Any = None):
        from ..launch.steps import jitted_step_for_cell, make_train_step
        self.cfg = cfg
        self.mesh = mesh
        self.data = data
        self.tc = tc
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=tc.steps, warmup_steps=max(tc.steps // 20, 1))
        self.failure_hook = failure_hook
        self.ckpt = AsyncCheckpointer(tc.ckpt_dir, keep=tc.keep_ckpts)
        self.watchdog = StragglerWatchdog(tc.straggler_factor)
        self.metrics: List[Dict[str, float]] = []
        if mesh is None:
            self._step_fn = make_train_step(
                cfg, self.opt_cfg, microbatches=tc.microbatches,
                mixed_precision=tc.mixed_precision, inplace=True)
        else:
            dc = data.cfg
            shape = ShapeConfig("train", dc.seq_len, dc.global_batch,
                                "train")
            self._step_fn = jitted_step_for_cell(
                cfg, shape, mesh, self.opt_cfg,
                microbatches=tc.microbatches,
                mixed_precision=tc.mixed_precision)[0]

    @property
    def _lead(self) -> bool:
        """Whether this process reports: one process, or rank 0 of a
        mesh."""
        import torch.distributed as dist
        return self.mesh is None or dist.get_rank() == 0

    # -- state management ----------------------------------------------------
    def init_state(self, params: Any = None) -> TrainState:
        """Float32 masters drawn from a generator on the device seeded with
        ``tc.seed`` — or ``params`` (the port's tree, taken as it is: the
        steps update it in place), and zero moments."""
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.tc.seed)
            params = M.init(self.cfg, gen, device=self.device,
                            dtype=torch.float32)
        if self.tc.mixed_precision:
            return self._mixed(adamw.init_mixed(params), step=0)
        return TrainState(params=params, opt_state=adamw.init(params),
                          step=0)

    @staticmethod
    def _mixed(opt_state: adamw.AdamWMixedState, step: int) -> TrainState:
        """The state around a mixed optimizer state: working parameters are
        its masters in bfloat16."""
        return TrainState(
            params=tree_map(lambda t: t.to(torch.bfloat16),
                            opt_state.master),
            opt_state=opt_state, step=step)

    def _whole(self, state: TrainState) -> TrainState:
        """The state with its DTensors gathered (a collective on a mesh)."""
        if self.mesh is None:
            return state
        from ..launch.steps import gather_full
        opt = type(state.opt_state)(*(gather_full(f)
                                      for f in state.opt_state))
        return TrainState(params=gather_full(state.params), opt_state=opt,
                          step=state.step)

    def save(self, state: TrainState) -> None:
        state = self._whole(state)
        self.ckpt.save_async(
            state.step,
            {"params": params_to_jax(state.params, self.cfg),
             "opt": opt_state_to_jax(state.opt_state, self.cfg)},
            extra={"step": state.step})

    def try_restore(self) -> Optional[TrainState]:
        s = latest_step(self.tc.ckpt_dir)
        if s is None:
            return None
        spec = jax_spec(self.cfg)
        step = np.zeros((), np.int32)
        opt = (adamw.AdamWMixedState(step=step, m=spec, v=spec, master=spec)
               if self.tc.mixed_precision else
               adamw.AdamWState(step=step, m=spec, v=spec))
        tree, extra = restore(self.tc.ckpt_dir, s,
                              {"params": spec, "opt": opt},
                              device=self.device)
        if self.tc.mixed_precision:
            return self._mixed(opt_state_from_jax(tree["opt"], self.cfg,
                                                  device=self.device),
                               step=int(extra["step"]))
        return TrainState(
            params=params_from_jax(tree["params"], self.cfg,
                                   device=self.device, dtype=torch.float32),
            opt_state=opt_state_from_jax(tree["opt"], self.cfg,
                                         device=self.device),
            step=int(extra["step"]))

    # -- the loop -------------------------------------------------------------
    def run(self, state: TrainState,
            until: Optional[int] = None) -> TrainState:
        until = until if until is not None else self.tc.steps
        prefetch = Prefetcher(self.data, start_step=state.step)
        try:
            while state.step < until:
                step_idx, batch = prefetch.next()
                assert step_idx == state.step, "seekable-data invariant"
                if self.failure_hook is not None:
                    self.failure_hook(state.step)  # may raise (injection)
                t0 = time.perf_counter()
                params, opt_state, m = self._step_fn(
                    state.params, state.opt_state,
                    batch_to_device(batch, self.device))
                loss = m["loss"].item()     # the step is done on the card
                dt = time.perf_counter() - t0
                slow = self.watchdog.observe(state.step, dt)
                state = TrainState(params=params, opt_state=opt_state,
                                   step=state.step + 1)
                rec = {"step": state.step, "loss": loss,
                       "grad_norm": m["grad_norm"].item(),
                       "sec_per_step": dt, "straggler": bool(slow)}
                self.metrics.append(rec)
                if state.step % self.tc.log_every == 0 and self._lead:
                    print(f"[train] step={rec['step']} "
                          f"loss={rec['loss']:.4f} "
                          f"gnorm={rec['grad_norm']:.3f} "
                          f"{dt*1e3:.0f}ms" +
                          (" STRAGGLER" if slow else ""))
                if state.step % self.tc.ckpt_every == 0:
                    self.save(state)
            self.ckpt.wait()
            return state
        finally:
            prefetch.close()


def run_with_restarts(trainer: Trainer, max_restarts: int = 3,
                      until: Optional[int] = None) -> TrainState:
    """The fault-tolerance driver: on any step failure, restore the latest
    committed checkpoint (or reinit) and resume; give up after
    ``max_restarts`` consecutive failures."""
    restarts = 0
    state = trainer.try_restore() or trainer.init_state()
    while True:
        try:
            return trainer.run(state, until=until)
        except Exception as e:  # noqa: BLE001 — any failure triggers restart
            restarts += 1
            print(f"[train] FAILURE at step {state.step}: {e}; "
                  f"restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise
            try:
                trainer.ckpt.wait()
            # the restart path must survive whatever state the failed
            # step left in the checkpointer — repro: noqa[RPA001]
            except Exception:
                pass
            state = trainer.try_restore() or trainer.init_state()


__all__ = ["TrainConfig", "TrainState", "Trainer", "run_with_restarts",
           "StragglerWatchdog", "batch_to_device"]
