"""Training epochs as CUDA graphs: the port's counterpart of the JAX
package's one compiled program per cycle (``jax.jit(cycle,
donate_argnums=(0,))``, ``train/multi.py``).

A *unit* is a list of models that step together: one model, a stack of
models that differ only in their FF activation slope (stepped one after the
other), or every model of a merged cycle (``merge_scans``). A member of a
unit may also be a whole model grid (``train.grid``: ``M`` models in one
step), whose data carry the member axis first, whose permutation is
``(steps, M, B)`` and whose step returns ``M`` losses. For each unit and
batch size ``EpochEngine`` keeps static buffers: each member's cycle
data (copied in once a cycle: its inputs of any shape, its labels and, for a
model that takes them, its features), its epoch permutation ``(steps, B)``
or ``(steps, M, B)``, for a model with dropout its cycle's dropout key (0-d,
a grid's ``(M,)``: each step folds in its ``idx[0]``, so every replay draws
new masks), its per-step losses ``(steps,)`` or ``(steps, M)``, and one
device step counter that the step itself advances.
On the card the first cycle of a batch size runs ``WARMUP_STEPS`` steps
eagerly on a side stream, which makes the optimizer's state, the kernels'
one-time set-up (``ops.fused_embedding``'s border table, shared-memory
grants) and the cuDNN/cuBLAS handles, then captures one step of every member
in a ``torch.cuda.CUDAGraph`` and replays it for the rest of the epoch; later
cycles of that batch size only replay. An epoch is then ``steps`` calls of
``replay()`` with no other host work between them. A graph holds the
forward, the backward, the BatchNorm running-statistic updates (in place on
their buffers) and the AdamW step (capturable, its learning rate a device
tensor that ``train.loop._set_lr`` fills each cycle). When the batch size
changes, the graphs of the old one are freed and the new one is captured.

On a mesh (``Experiment.use_mesh``) a step's sums over ranks (the
gradients, the losses, BatchNorm's statistics, K2/K3's gathered rows) are
NCCL all-reduces that the graph captures with the rest; ``parallel.
make_mesh`` makes each communicator before any capture, and gloo's
collectives cannot be captured (``Experiment.run`` raises for them on the
card).

Eager execution runs the same step on the same buffers: that is how CPU
tensors run. On the card a capture that fails raises; nothing goes on
eagerly in its place (``experiments.Experiment`` runs eagerly on the card
only when its caller sets ``fused_cycles = False``, through each model's own
``train_cycle``). A step must make no host synchronisation and draw from no
generator: dropout hashes the key buffer and the step's indices
(``models.dropout``), so a captured epoch equals the eager one bitwise.

The kernel wrappers' launch counters count Python calls. A call made while
capturing records its kernels in the graph without running them, and a
replay runs them without a call: ``EpochEngine.recorded`` counts the
former, ``EpochEngine.replayed`` the launches replays made (replays × the
calls recorded in that graph), so the kernels a run launched are the
wrappers' counts − recorded + replayed (``kernel_launches``).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import torch

from moleculardiffusion_mivit_tpu_torch.train.loop import TrainState

# Eager steps before the first capture of a unit at a batch size. They are
# real steps of the epoch: the first creates AdamW's state, the second runs
# the path a replay will take.
WARMUP_STEPS = 2


def launch_counts() -> Dict[str, int]:
    """The launch counters of the hand-written kernels' wrappers."""
    from moleculardiffusion_mivit_tpu_torch.ops import fused_embedding as fe
    from moleculardiffusion_mivit_tpu_torch.ops.render import render_frames

    kernels = (render_frames, *fe.kernels_for(torch.float32), *fe.kernels_for(torch.bfloat16))
    return {f.__name__: f.launches for f in kernels}


class Member(NamedTuple):
    """One model of a unit, with what its epoch reads."""

    name: str
    state: TrainState
    train_step: Callable  # train.loop's train_step(state, videos, labels, idx, act_slope, features)
    videos: torch.Tensor  # the model's first input, (N, ...); a grid's (M, N, ...)
    labels: torch.Tensor
    perm: torch.Tensor  # (steps, batch) minibatch indices on the data's device; a grid's (steps, M, batch)
    act_slope: Optional[torch.Tensor] = None
    features: Optional[torch.Tensor] = None  # (N, F), for a model that takes them
    drop_key: Optional[torch.Tensor] = None  # the cycle's dropout key (int64, a grid's (M,)), for dropout > 0


def _shape(t: Optional[torch.Tensor]):
    return None if t is None else t.shape


class _Unit:
    """Static buffers of one unit at one batch size, and its graph once
    captured."""

    def __init__(self, members: Sequence[Member]):
        self.names = tuple(m.name for m in members)
        self.states = [m.state for m in members]
        self.train_steps = [m.train_step for m in members]
        self.slopes = [m.act_slope for m in members]
        self.videos = [torch.empty_like(m.videos) for m in members]
        self.labels = [torch.empty_like(m.labels) for m in members]
        self.features = [None if m.features is None else torch.empty_like(m.features) for m in members]
        self.perms = [torch.empty_like(m.perm) for m in members]
        self.drop_keys = [None if m.drop_key is None else torch.empty_like(m.drop_key) for m in members]
        self.losses = [torch.empty(m.perm.shape[:-1], device=m.perm.device) for m in members]
        self.counter = torch.zeros(1, dtype=torch.long, device=members[0].perm.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches_per_replay: Dict[str, int] = {}

    def matches(self, members: Sequence[Member]) -> bool:
        return all(
            m.state is s and m.videos.shape == v.shape and m.labels.shape == y.shape
            and m.perm.shape == p.shape and _shape(m.features) == _shape(f) and _shape(m.drop_key) == _shape(k)
            for m, s, v, y, p, f, k in zip(members, self.states, self.videos, self.labels, self.perms, self.features,
                                           self.drop_keys, strict=True)
        )

    def load(self, members: Sequence[Member]) -> None:
        for m, v, y, p, f, k in zip(members, self.videos, self.labels, self.perms, self.features, self.drop_keys):
            v.copy_(m.videos)
            y.copy_(m.labels)
            p.copy_(m.perm)
            if f is not None:
                f.copy_(m.features)
            if k is not None:
                k.copy_(m.drop_key)
        self.counter.zero_()

    def step(self) -> None:
        """One minibatch of every member, then the counter moves on."""
        for i, state in enumerate(self.states):
            idx = self.perms[i].index_select(0, self.counter)[0]
            loss = self.train_steps[i](state, self.videos[i], self.labels[i], idx, self.slopes[i],
                                       features=self.features[i], drop_key=self.drop_keys[i])
            self.losses[i].index_copy_(0, self.counter, loss.unsqueeze(0))
        self.counter.add_(1)


class EpochEngine:
    """Runs one training epoch of each unit: captured on a CUDA device,
    eagerly on the CPU (see the module docstring).

    ``units`` maps each unit's member names to its buffers and graph at the
    current batch size. Counters for measurement: ``captures`` and
    ``replays`` so far,
    ``replay_host_s`` (host seconds spent in ``replay()`` calls),
    ``recorded`` and ``replayed`` (kernel-wrapper calls recorded at capture,
    and the launches replays made). Setting ``unit_seconds`` to a dict makes
    ``run`` synchronise around each unit and record its wall seconds there,
    keyed by the unit's member names."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.units: Dict[tuple, _Unit] = {}
        self._batch_size: Optional[int] = None
        self.captures = 0
        self.replays = 0
        self.replay_host_s = 0.0
        self.recorded: Counter = Counter()
        self.replayed: Counter = Counter()
        self.unit_seconds: Optional[Dict[tuple, float]] = None

    def release(self) -> None:
        """Drop every graph and static buffer; the next epoch captures anew.
        Call after a member's parameters or optimizer state were replaced
        (``optimizer.load_state_dict`` makes new tensors a graph never saw)."""
        for unit in self.units.values():
            for state in unit.states:
                state.optimizer.zero_grad(set_to_none=True)  # gradients live in the graph's pool
        self.units.clear()

    def run(self, units: Sequence[Sequence[Member]], batch_size: int) -> Dict[str, torch.Tensor]:
        """One epoch of every unit at ``batch_size``; returns each member's
        mean loss (a 0-d tensor on its device, a grid's ``(M,)``; NaN for an
        epoch of no step)."""
        if batch_size != self._batch_size:
            self.release()
            self._batch_size = batch_size
        losses: Dict[str, torch.Tensor] = {}
        for members in units:
            steps = members[0].perm.shape[0]
            if steps == 0:
                losses.update({m.name: torch.full(m.perm.shape[1:-1], float("nan"), device=m.perm.device)
                               for m in members})
                continue
            key = tuple(m.name for m in members)
            unit = self.units.get(key)
            if unit is None or not unit.matches(members):
                unit = self.units[key] = _Unit(members)
            unit.load(members)
            t0 = self._mark()
            self._epoch(unit, steps)
            if self.unit_seconds is not None:
                self.unit_seconds[key] = self._mark() - t0
            losses.update({name: buf.mean() if buf.ndim == 1 else buf.mean(dim=0)
                           for name, buf in zip(unit.names, unit.losses)})
        return losses

    def _mark(self) -> float:
        if self.unit_seconds is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _epoch(self, unit: _Unit, steps: int) -> None:
        if not self.capture:
            for _ in range(steps):
                unit.step()
            return
        done = 0
        if unit.graph is None:
            done = min(WARMUP_STEPS, steps)
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                for _ in range(done):
                    unit.step()
            current.wait_stream(side)
            self._capture(unit)
        n = steps - done
        t0 = time.perf_counter()
        for _ in range(n):
            unit.graph.replay()
        self.replay_host_s += time.perf_counter() - t0
        self.replays += n
        self.replayed.update({k: v * n for k, v in unit.launches_per_replay.items()})

    def _capture(self, unit: _Unit) -> None:
        for state in unit.states:
            state.optimizer.zero_grad(set_to_none=True)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            unit.step()
        after = launch_counts()
        unit.launches_per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        unit.graph = graph
        self.captures += 1
        self.recorded.update(unit.launches_per_replay)


def kernel_launches(counts_before: Dict[str, int], engines: Sequence[EpochEngine] = ()) -> Dict[str, int]:
    """Kernel launches since ``counts_before`` (a ``launch_counts()``
    snapshot taken when the ``engines``' ``recorded`` and ``replayed`` were
    cleared): wrapper calls, less those recorded at capture, plus the
    launches replays made."""
    now = launch_counts()
    out = {k: now[k] - counts_before[k] for k in now}
    for eng in engines:
        for k in out:
            out[k] += eng.replayed[k] - eng.recorded[k]
    return out


def units_by_layout(names: List[str], stacks: Sequence[Sequence[str]], merge: bool) -> List[List[str]]:
    """The units of a cycle: every name in one unit when ``merge``; else each
    stack (a list of names) as one unit after every name in no stack, each
    on its own, in order."""
    if merge:
        return [list(names)]
    stacked = {n for group in stacks for n in group}
    return [[n] for n in names if n not in stacked] + [list(g) for g in stacks]
