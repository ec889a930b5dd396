"""Batching host loader: sample dicts -> StereoSample of CPU tensors.

Counterpart of gps_gaussian_tpu/data/loader.py `collate` :26, `BatchLoader`
:76 and `eval_batches` :179. Worker threads, or spawned worker processes,
build and stack batches while the device computes. Training batches sample
without replacement: a shuffled epoch permutation of the scan indices is
drawn down and reshuffled when exhausted; per-host sharding slices the scan
list by process index. A data-parallel rank passes `rows`, its slice of
each global batch, and builds only those samples: the batch sequence is
the one a single process draws, and the rank's rows are equal to that
batch's rows.

One divergence from the JAX loader, which hands out batches in whichever
order its workers finish them (so a fixed seed does not fix the data
order): here every task carries its sequence number and the consumer
delivers batches in task order, whatever the number of workers. The k-th
batch is the one built from the k-th draw of the loader's generator.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from gps_gaussian_tpu_torch.utils.containers import (NovelCamera, NovelView,
                                                     SourceView, StereoSample)

_SOURCE_KEYS = ("img", "mask", "intr", "ref_intr", "extr", "tf_x")
_CAMERA_KEYS = ("view", "proj", "cam_center", "tanfovx", "tanfovy")


def collate(samples: Sequence[dict]) -> StereoSample:
    """Stack unbatched sample dicts into one StereoSample of CPU tensors."""

    def stack(dicts, key):
        return torch.from_numpy(np.stack([d[key] for d in dicts]))

    def stack_view(view: str) -> SourceView:
        d = [s[view] for s in samples]
        keys = _SOURCE_KEYS + (("flow", "valid") if "flow" in d[0] else ())
        return SourceView(**{k: stack(d, k) for k in keys})

    novel = None
    if "novel" in samples[0]:
        d = [s["novel"] for s in samples]
        camera = NovelCamera(height=int(d[0]["height"]),
                             width=int(d[0]["width"]),
                             **{k: stack(d, k) for k in _CAMERA_KEYS})
        novel = NovelView(camera=camera, img=stack(d, "img"),
                          intr=stack(d, "intr"), extr=stack(d, "extr"))
    return StereoSample(lmain=stack_view("lmain"), rmain=stack_view("rmain"),
                        novel=novel)


def _check_rows(rows: Optional[slice], batch_size: int):
    """(start, stop) of a contiguous, non-empty slice of a batch."""
    if rows is None:
        return 0, batch_size
    lo, hi, step = rows.indices(batch_size)
    if step != 1 or hi <= lo:
        raise ValueError(f"rows {rows} is not a contiguous, non-empty slice "
                         f"of a batch of {batch_size}")
    return lo, hi


def _build(dataset, novel_ids, idxs, seed, rows: slice) -> StereoSample:
    """Rows `rows` of the batch of scan indices `idxs` whose samples draw,
    one after another, from default_rng(seed). A sample outside `rows` is
    not built, but its draw is replayed: a dataset's get_sample draws
    exactly one rng.choice(list(novel_ids)) when novel_ids is given
    (StereoHumanDataset and the datasets of testing.py)."""
    rng = np.random.default_rng(seed)
    samples = []
    for j, i in enumerate(idxs):
        if rows.start <= j < rows.stop:
            samples.append(dataset.get_sample(int(i), novel_ids, rng))
        elif novel_ids is not None:
            rng.choice(list(novel_ids))
    return collate(samples)


def _proc_worker(setup_q, task_q, out_q):
    """Worker-process loop: (seq, indices, seed) tasks -> (seq, batch).
    The dataset arrives through `setup_q`, not as a start argument: a large
    argument would hold the parent in `start()` until this process had
    imported everything, one worker after another. The batch's tensors
    reach the consumer through shared memory (torch's multiprocessing
    pickler), not through the pipe. CPU only: it never touches a GPU."""
    dataset, novel_ids, rows = setup_q.get()
    while True:
        task = task_q.get()
        if task is None:
            return
        seq, idxs, seed = task
        try:
            out_q.put((seq, _build(dataset, novel_ids, idxs, seed, rows)))
        except Exception as e:  # surfaces in the consumer, not as a hang
            out_q.put((seq, e))


class BatchLoader:
    """Infinite epoch-shuffled batch iterator with prefetch, in task order.

    num_procs > 0 spawns that many worker processes (never forks: the
    caller has initialised CUDA by then); num_procs = 0 uses `num_threads`
    Python threads. At most prefetch + workers batches are drawn and not
    yet delivered; those that finish early wait for their turn. `rows`
    (default: all) is the slice of each batch of `batch_size` that this
    loader builds and delivers."""

    def __init__(self, dataset, batch_size: int,
                 novel_ids: Optional[Sequence[int]], seed: int = 1314,
                 prefetch: int = 2, num_threads: int = 2,
                 num_procs: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 rows: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.rows = slice(*_check_rows(rows, batch_size))
        self.novel_ids = novel_ids
        self.rng = np.random.default_rng(seed + process_index)
        self._rng_lock = threading.Lock()
        n = len(dataset)
        self.indices = list(range(process_index, n, process_count)) or [0]
        self._perm: list = []
        self._seq = 0          # sequence number of the next task drawn
        self._next_out = 0     # sequence number of the next batch delivered
        self._early: dict = {}  # batches that finished before their turn
        self._window = threading.Semaphore(
            prefetch + max(num_procs, num_threads))
        self._stop = threading.Event()
        self.procs: list = []
        self.threads: list = []
        if num_procs > 0:
            ctx = mp.get_context("spawn")
            self._setup_q = ctx.Queue()
            self._task_q = ctx.Queue()
            self.q = ctx.Queue()
            self.procs = [
                ctx.Process(target=_proc_worker,
                            args=(self._setup_q, self._task_q, self.q),
                            daemon=True)
                for _ in range(num_procs)]
            for p in self.procs:
                p.start()
                self._setup_q.put((dataset, novel_ids, self.rows))
            self.threads = [threading.Thread(target=self._feeder,
                                             daemon=True)]
        else:
            self.q = queue.Queue()
            self.threads = [threading.Thread(target=self._worker,
                                             daemon=True)
                            for _ in range(num_threads)]
        for t in self.threads:
            t.start()

    def _next_task(self):
        """(sequence number, epoch-permutation indices, sampling seed)."""
        with self._rng_lock:
            while len(self._perm) < self.batch_size:
                self._perm.extend(
                    self.rng.permutation(self.indices).tolist())
            idxs = self._perm[: self.batch_size]
            del self._perm[: self.batch_size]
            seed = int(self.rng.integers(2 ** 31))
            seq = self._seq
            self._seq += 1
        return seq, idxs, seed

    def _acquire(self) -> bool:
        """A slot in the prefetch window; False once the loader stops."""
        while not self._stop.is_set():
            if self._window.acquire(timeout=0.5):
                return True
        return False

    def _worker(self):
        while self._acquire():
            seq, idxs, seed = self._next_task()
            try:
                item = _build(self.dataset, self.novel_ids, idxs, seed,
                              self.rows)
            except Exception as e:  # surfaces in the consumer
                item = e
            self.q.put((seq, item))

    def _feeder(self):
        while self._acquire():
            self._task_q.put(self._next_task())

    def _get(self):
        while True:
            try:
                return self.q.get(timeout=1.0)
            except queue.Empty:
                if self.procs and not any(p.is_alive() for p in self.procs):
                    raise RuntimeError("every loader worker process died")

    def __iter__(self):
        return self

    def __next__(self) -> StereoSample:
        while self._next_out not in self._early:
            seq, item = self._get()
            self._early[seq] = item
        item = self._early.pop(self._next_out)
        self._next_out += 1
        self._window.release()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        for t in self.threads:
            t.join(timeout=2.0)
        for p in self.procs:
            p.terminate()
        for p in self.procs:
            p.join(timeout=2.0)
        if self.procs:
            # batches left in the pipes must not hold up interpreter exit
            for q in (self._setup_q, self._task_q, self.q):
                q.cancel_join_thread()


def eval_batches(dataset, batch_size: int,
                 novel_ids: Optional[Sequence[int]], seed: int = 1234,
                 process_index: int = 0, process_count: int = 1,
                 max_batches: Optional[int] = None,
                 rows: Optional[slice] = None) -> Iterator[tuple]:
    """Deterministic full sweep of the val set in fixed-size batches.

    Every index is visited once, in order, with a per-sample generator
    seeded by the index, so the novel-view choice is the same run to run.
    A short tail is wrapped to keep the batch shape; yields
    (StereoSample, weight) with weight a (batch_size,) f32 tensor, 1 for
    first-visit samples and 0 for the wrapped duplicates. The number of
    batches derives from the global dataset length, so every process runs
    the same number. With `rows`, only that slice of each batch (and of
    its weight) is built and yielded."""
    lo, hi = _check_rows(rows, batch_size)
    idxs = list(range(process_index, len(dataset), process_count)) or [0]
    shard_len = max(-(-len(dataset) // process_count), 1)
    n_batches = -(-shard_len // batch_size)
    if max_batches is not None:
        n_batches = min(n_batches, max_batches)
    n_live = len(range(process_index, len(dataset), process_count))
    for b in range(n_batches):
        pos = [b * batch_size + j for j in range(lo, hi)]
        chunk = [idxs[p % len(idxs)] for p in pos]
        weight = torch.tensor([1.0 if p < n_live else 0.0 for p in pos],
                              dtype=torch.float32)
        samples = [dataset.get_sample(int(i), novel_ids,
                                      np.random.default_rng(seed + int(i)))
                   for i in chunk]
        yield collate(samples), weight
