"""Training loop: data iterator, train step, checkpoints, logging, eval.

Port of ``mmdet3d_gaussian_tpu/engine/loop.py``: a Python loop around the
detector's ``train_step``, checkpoints every ``checkpoint_config.interval``
epochs, JSON-lines logging every ``log_interval`` steps (the reference's
TextLoggerHook) and an optional ``torch.profiler`` trace.

Data parallel (a detector with a ``group``, ``parallel/mesh.py``), as the
JAX loop on several processes: ``samples_per_gpu`` is the global batch B,
which must divide by the R ranks; every rank draws the same seeded
permutation and loads rows ``order[m B + r B / R : m B + (r + 1) B / R]``
of global batch m.  Rank 0 alone writes the log and the checkpoints and
runs the evaluation while the others wait; ``resume_from`` and
``load_from`` load on every rank.

Checkpoints are ``ckpt_{step}.pt``: a plain dict (``state_dict``: the
trunk's parameters and BatchNorm buffers; ``opt_state``: AdamW's ``count``
and its ``mu`` and ``nu`` keyed by parameter name; ``step``) that loads
with ``torch.load(..., weights_only=True)``, beside a ``meta_{step}.json``
sidecar.  ``resume_from`` restores all of it; ``load_from`` only the
weights (``state_dict``; a fresh optimizer at step 0).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..parallel.mesh import barrier
from ..parallel.train_state import (OptState, TrainState,
                                    make_optimizer_from_cfg)

BATCH_KEYS = ('points', 'points_mask', 'gt_bboxes', 'gt_labels', 'gt_valid')


def build_dataloader(cfg, split: str = 'train', group=None):
    """Dataset + ``iterator(seed)`` of collated numpy batches.

    ``data.workers_per_gpu`` threads map ``dataset[idx]`` (see
    ``engine/prefetch.py``).  Train shuffles (seeded) and drops the last
    partial batch; eval splits iterate in order and pad the last batch by
    repeating its last sample (cut the results to ``len(dataset)``).
    Under ``group`` the train iterator yields this rank's rows of each
    global batch of ``samples_per_gpu`` (see the module docstring)."""
    from .. import datasets  # noqa: F401  (registers the datasets)
    from ..datasets.pipelines import collate_batch
    from ..registry import DATASETS
    from .prefetch import pooled_sample_iterator

    data_cfg = dict(cfg.get('data', {}).get(split, {}))
    if not data_cfg:
        raise KeyError(
            f"config has no data.{split} section (data keys: "
            f"{sorted(cfg.get('data', {}).keys())})")
    ds = DATASETS.build(data_cfg)
    batch_size = int(cfg.get('data', {}).get('samples_per_gpu', 4))
    workers = int(cfg.get('data', {}).get('workers_per_gpu', 2))
    shuffle = split == 'train'
    bsz = batch_size
    if shuffle and group is not None:
        if batch_size % group.world:
            raise ValueError(f'samples_per_gpu {batch_size} (the global '
                             f'batch) must divide by the {group.world} '
                             f'ranks')
        bsz = batch_size // group.world

    def iterator(seed: int = 0) -> Iterator[Dict]:
        rng = np.random.RandomState(seed)
        order = rng.permutation(len(ds)) if shuffle else range(len(ds))
        if bsz != batch_size:
            # every rank draws the same order and takes its slice of each
            # global batch
            nb = len(ds) // batch_size
            r = group.rank
            order = order[:nb * batch_size].reshape(nb, batch_size)[
                :, r * bsz:(r + 1) * bsz].reshape(-1)
        return pooled_sample_iterator(ds, order, bsz, collate_batch,
                                      workers=workers,
                                      pad_partial=not shuffle)

    return ds, iterator


def to_device(batch: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A collated numpy batch (``metas`` dropped) -> tensors on ``device``:
    on a card through pinned host memory with ``non_blocking`` copies on
    the current stream, so the copy runs behind the kernels queued before
    it and a step queued after it reads the copied batch."""
    out = {}
    for k in BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == 'cuda':
            # this rank's card is current in the calling thread (the
            # prefetch producer's too), so the pinned buffer and the copy
            # belong to it and no other card gets a context
            with torch.cuda.device(device):
                t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def save_checkpoint(work_dir: str, state: TrainState, step: int,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``ckpt_{step}.pt`` (and ``meta_{step}.json`` with ``meta``)
    into ``work_dir``; -> the checkpoint's path."""
    def host(tensors):
        return {k: v.detach().cpu() for k, v in tensors.items()}

    opt = state.opt_state
    ckpt = dict(state_dict=host({**state.params, **state.batch_stats}),
                opt_state=dict(count=int(opt.count), mu=host(opt.mu),
                               nu=host(opt.nu)),
                step=int(step))
    path = os.path.abspath(os.path.join(work_dir, f'ckpt_{step}.pt'))
    torch.save(ckpt, path)
    if meta:
        with open(os.path.join(work_dir, f'meta_{step}.json'), 'w') as f:
            json.dump(meta, f, indent=1, default=str)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location='cpu', weights_only=True)


def restore_checkpoint(path: str, det, state: TrainState,
                       weights_only: bool = False) -> TrainState:
    """Load ``path`` into ``det``'s trunk (every parameter and buffer,
    strictly) and, unless ``weights_only``, AdamW's state and the step;
    -> the restored state (``state`` itself for ``weights_only``)."""
    ckpt = load_checkpoint(path)
    det.trunk.load_state_dict(ckpt['state_dict'], strict=True)
    if weights_only:
        return state
    dev = det.device
    opt = ckpt['opt_state']
    if set(opt['mu']) != set(state.params):
        raise KeyError(f'{path}: optimizer state for other parameters')
    opt_state = OptState(int(opt['count']),
                         {k: v.to(dev) for k, v in opt['mu'].items()},
                         {k: v.to(dev) for k, v in opt['nu'].items()})
    return state._replace(step=int(ckpt['step']), opt_state=opt_state)


def run_training(det, cfg, work_dir: str, seed: int = 0,
                 max_steps: Optional[int] = None,
                 resume_from: Optional[str] = None,
                 load_from: Optional[str] = None,
                 eval_interval: Optional[int] = None,
                 log_interval: Optional[int] = None,
                 profile_steps: Optional[tuple] = None) -> TrainState:
    """Train ``det`` (a detector on its device, initialized from its seed)
    as ``cfg`` says.  Runtime knobs resolve argument -> config key ->
    default, as the reference's ``default_runtime.py`` keys
    (``checkpoint_config.interval``, ``log_config.interval``,
    ``evaluation.interval``, ``load_from``, ``resume_from``).
    ``max_steps`` also sets the length of the learning-rate schedule.

    Log records: each loss term, ``loss``, ``grad_norm``, ``step``,
    ``epoch``, ``time`` (seconds since the loop began), ``data_time``
    (seconds this step waited for its batch) and, on a card, ``memory``
    (peak MiB allocated); under a group the losses are the whole batch's
    and the times and memory rank 0's."""
    resume_from = resume_from or cfg.get('resume_from')
    load_from = load_from or cfg.get('load_from')
    if log_interval is None:
        log_interval = int((cfg.get('log_config') or {}).get('interval', 50))
    if eval_interval is None:
        eval_interval = int((cfg.get('evaluation') or {}).get('interval', 0))
    ckpt_interval = int((cfg.get('checkpoint_config') or {})
                        .get('interval', 1))

    group = det.group
    dist = torch.distributed
    if (group is None and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise RuntimeError('a job of more than one process trains a '
                           'detector built with its group '
                           '(parallel.mesh.init_distributed)')
    is_main = group is None or group.rank == 0
    ds, make_iter = build_dataloader(cfg, 'train', group)
    epochs = int(cfg.get('max_epochs', 40))
    batch_size = int(cfg.get('data', {}).get('samples_per_gpu', 4))
    steps_per_epoch = max(1, len(ds) // batch_size)
    total_steps = max_steps or epochs * steps_per_epoch

    optimizer = make_optimizer_from_cfg(cfg, total_steps,
                                        steps_per_epoch=steps_per_epoch)
    state = det.init_train(optimizer=optimizer)
    if resume_from:
        state = restore_checkpoint(resume_from, det, state)
    elif load_from:
        # the reference's `load_from`: weights only; step and optimizer
        # state start afresh (mmcv runner.load_checkpoint)
        state = restore_checkpoint(load_from, det, state, weights_only=True)

    from .prefetch import prefetch

    def place(b):
        # in the producer thread: collated numpy -> tensors on the device
        return to_device(b, det.device)

    on_card = det.device.type == 'cuda'
    log_path = os.path.join(work_dir, 'train_log.jsonl')
    step = state.step
    prof = None
    t0 = time.perf_counter()
    with (open(log_path, 'a') if is_main
          else contextlib.nullcontext()) as logf:
        for epoch in range(epochs):
            if step >= total_steps:
                break
            pf = prefetch(make_iter(seed + epoch), depth=2, place_fn=place)
            try:
                while True:
                    t_wait = time.perf_counter()
                    try:
                        batch = next(pf)
                    except StopIteration:
                        break
                    data_time = time.perf_counter() - t_wait
                    if is_main and profile_steps \
                            and step == profile_steps[0]:
                        prof = _start_profile()
                    state, metrics = det.train_step(batch, state)
                    step = state.step
                    if prof is not None and step == profile_steps[1]:
                        _stop_profile(prof, work_dir)
                        prof = None
                    if is_main and step % log_interval == 0:
                        rec = {k: float(v) for k, v in metrics.items()}
                        rec.update(step=step, epoch=epoch,
                                   time=time.perf_counter() - t0,
                                   data_time=data_time)
                        if on_card:
                            rec['memory'] = (torch.cuda.max_memory_allocated(
                                det.device) / 2 ** 20)
                        logf.write(json.dumps(rec) + '\n')
                        logf.flush()
                        print(f'step {step}: loss={rec["loss"]:.4f}')
                    if step >= total_steps:
                        break
            finally:
                pf.close()   # unblock the producer on an early exit
            last_epoch = (epoch + 1 == epochs) or step >= total_steps
            if is_main and ((epoch + 1) % ckpt_interval == 0 or last_epoch):
                meta = dict(step=step, epoch=epoch,
                            classes=list(getattr(ds, 'CLASSES', []) or []),
                            torch_version=torch.__version__,
                            config=cfg.to_dict() if hasattr(cfg, 'to_dict')
                            else None)
                save_checkpoint(work_dir, state, step, meta=meta)
            # the reference's evaluation hook (`evaluation = dict(interval)`)
            if (is_main and eval_interval
                    and (epoch + 1) % eval_interval == 0
                    and cfg.get('data', {}).get('val')):
                report = run_evaluation(det, cfg)
                rec = {f'val/{k}': float(v) for k, v in report.items()}
                rec.update(step=step, epoch=epoch)
                logf.write(json.dumps(rec) + '\n')
                logf.flush()
                print(f'eval @ epoch {epoch}: {rec}')
            if group is not None:
                barrier(group)      # the others wait for rank 0's writes
    if prof is not None:
        _stop_profile(prof, work_dir)
    return state


def _start_profile():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, work_dir: str) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    out = os.path.join(work_dir, 'profile')
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, 'trace.json'))
    print('profiler trace written to', out)


def detector_num_classes(det) -> int:
    """Total class count of a detector's head."""
    head = getattr(det, 'head', None) or getattr(det, 'rpn_head', None)
    if hasattr(head, 'num_classes'):
        return int(head.num_classes)
    if hasattr(head, 'tasks'):
        return int(sum(t['num_classes'] for t in head.tasks))
    raise AttributeError(f'cannot infer num_classes from {det!r}')


def detections_to_per_class(boxes, scores, labels, valid,
                            num_classes: int):
    """One sample's padded (K, 7) / (K,) / (K,) / (K,) numpy detections ->
    a list of per-class (N, 8) [box7, score] f32 arrays."""
    out = []
    for c in range(num_classes):
        sel = valid & (labels == c)
        out.append(np.concatenate([boxes[sel][:, :7], scores[sel][:, None]],
                                  -1).astype(np.float32))
    return out


def predict_split(det, cfg, split: str = 'val'):
    """Predict over a split in order -> (dataset, per frame per-class
    detections cut to ``len(dataset)``)."""
    ds, make_iter = build_dataloader(cfg, split)
    num_classes = detector_num_classes(det)
    results = []
    for batch in make_iter(0):
        out = det.predict(to_device(batch, det.device))
        boxes, scores, labels, valid = (t.cpu().numpy() for t in out)
        for i in range(boxes.shape[0]):
            results.append(detections_to_per_class(
                boxes[i], scores[i], labels[i], valid[i], num_classes))
    return ds, results[:len(ds)]


def run_evaluation(det, cfg) -> Dict[str, float]:
    """Predict over the val split and run ``dataset.evaluate``."""
    ds, results = predict_split(det, cfg, 'val')
    return ds.evaluate(results)
