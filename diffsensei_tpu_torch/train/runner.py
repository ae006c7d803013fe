"""The training loop: steps, logging, checkpoints, resume (port of
``diffsensei_tpu/train/runner.py``).

Shared by the stage entry points. As in the JAX package: resume restores the
full train state (trainables, optimizer, step, generator), gradient
accumulation lives in the optimizer (``optax.MultiSteps`` semantics), and
SIGTERM/SIGINT end the loop after the current step with a checkpoint. The
draws come from one generator seeded from ``seed``, whose state every
checkpoint keeps. Unlike the JAX loop, the data stream is asked for from the
restored step on (``batches_from(step)``), so a resumed run sees the batches
the uninterrupted one would have seen, not the first epoch again.

Under data parallelism (``env``, the rank's ``parallel.mesh.Distributed``)
every rank runs the loop and gathers a checkpoint's state (its sharded
tensors whole), rank 0 alone writes ``metrics.jsonl`` and the checkpoints,
and the ranks wait for it before going on; on resume every rank reads the
checkpoint and puts each tensor back into its sharding.
"""

from __future__ import annotations

import dataclasses
import signal
from typing import Any, Callable, Iterable, Optional

import torch
import torch.distributed as dist

from diffsensei_tpu_torch.parallel.mesh import Distributed
from diffsensei_tpu_torch.train.checkpoint import CheckpointManager
from diffsensei_tpu_torch.train.diffusion import TrainState
from diffsensei_tpu_torch.utils.observability import (
    MetricsLogger, StepTimer, device_memory_stats)


@dataclasses.dataclass
class RunConfig:
    max_train_steps: int
    log_dir: str
    log_every: int = 50
    checkpoint_every: int = 1000
    # explicit extra checkpoint steps (the reference's ``checkpointing_steps``)
    checkpoint_steps: tuple = ()
    checkpoints_total_limit: Optional[int] = 5
    seed: int = 0
    resume: bool = False
    memory_log_every: int = 500


def run_training(step_fn: Callable, state: TrainState,
                 batches_from: Callable[[int], Iterable[Any]], cfg: RunConfig,
                 frozen=None, device="cuda",
                 on_step: Optional[Callable[[int, dict], None]] = None,
                 env: Optional[Distributed] = None) -> TrainState:
    """Drive ``step_fn(state, frozen, batch, generator) -> metrics`` over
    ``batches_from(first_step)`` until ``max_train_steps``;
    ``on_step(step, metrics)`` sees every step's metrics (tensors on the
    device). ``env``: the rank, when the run is data-parallel."""
    device = torch.device(device)
    writer = env is None or env.is_writer
    ckpt = CheckpointManager(cfg.log_dir, cfg.checkpoints_total_limit)
    metrics_log = MetricsLogger(cfg.log_dir) if writer else None

    def save(step: int) -> None:
        payload = state.state_dict()        # a collective where tensors are sharded
        if writer:
            ckpt.save(step, payload, generator.get_state())
        if env is not None:
            dist.barrier(env.group)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    if cfg.resume:
        try:
            restored, gen_state, step = ckpt.restore()
        except FileNotFoundError:
            pass
        else:
            state.load_state_dict(restored)
            generator.set_state(gen_state)
            print(f"resumed from step {step}")

    # preemption: finish the step, checkpoint, leave the loop
    interrupted = {"flag": False}

    def _on_signal(signum, frame):
        interrupted["flag"] = True

    prev_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:   # not the main thread
            pass

    start_step = step = state.step
    batches = iter(batches_from(start_step))
    timer = StepTimer()
    try:
        for batch in batches:
            if step >= cfg.max_train_steps or interrupted["flag"]:
                break
            timer.data_ready()
            metrics = step_fn(state, frozen, batch, generator)
            if on_step is not None:
                on_step(step + 1, metrics)
            if (step + 1) % cfg.log_every == 0 or step + 1 == cfg.max_train_steps:
                scalars = {k: float(v) for k, v in metrics.items()}  # waits for the step
                timer.step_done()
                scalars.update(timer.scalars())
                if (step + 1) % cfg.memory_log_every == 0:
                    scalars.update(device_memory_stats(device))
                if metrics_log is not None:
                    metrics_log.log(step + 1, scalars)
            else:
                timer.step_done()
            step += 1
            if (step % cfg.checkpoint_every == 0 or step == cfg.max_train_steps
                    or step in cfg.checkpoint_steps):
                save(step)
        if step > start_step and step % cfg.checkpoint_every != 0 \
                and step != cfg.max_train_steps:
            save(step)
    finally:
        if hasattr(batches, "close"):
            batches.close()              # stops a prefetching producer
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        if metrics_log is not None:
            metrics_log.close()
    return state
