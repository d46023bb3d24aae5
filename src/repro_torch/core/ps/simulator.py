"""The paper's asynchronous parameter server (§4.2) on one device: one
server + P workers, real threads, real message queues (counterpart of
``repro/core/ps/simulator.py``).

  server: update thread + (implicit) communication thread — pops gradient
          messages from the inbound queue, applies them to the global L with
          a server-side optimizer, pushes fresh parameters to every worker's
          inbound queue.
  worker: local computing thread — samples a minibatch from ITS OWN pair
          shard (S_p, D_p), computes the Eq. 4 gradient against its local
          copy L_p, pushes the gradient to the server, and opportunistically
          (non-blocking) pulls the freshest parameters the server sent.

Threads run best-effort exactly as described in the paper: nobody blocks on
anybody; coordination is only through the queues. The gradient is the
reference's, ``dml.objective`` by autograd (plain f32 products, not the
``dml_pair`` kernel).

Messages, parameters and broadcasts are tensors on the run's device, never
host copies: at paper width (d_in 21504, d_out 1000) a message is 86 MB.
No thread mutates a tensor it has handed over; each update makes a new one.
On the card every thread issues its work on a CUDA stream of its own, so
one worker's loss read (a sync per message) waits for its own work only.
A tensor crosses threads with a CUDA event recorded on its producer's
stream after the work that wrote it (``_send``); the consumer makes its
stream wait on that event and marks the tensor as used there
(``_receive``, ``record_stream``), so the caching allocator does not hand
the block back to the producer's stream while the consumer still reads it.
On the CPU a tensor is ready when it is handed over.

A thread's exception is kept and raised again by ``run_async_dml`` after
the joins, and a thread still alive after its join timeout is an error.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import dml
from repro_torch.core.ps.trainer import make_worker_streams
from repro_torch.device import resolve_device
from repro_torch.kernels._dispatch import full_f32


@dataclasses.dataclass
class AsyncPSConfig:
    n_workers: int
    lr: float = 1e-2
    batch_size: int = 100           # per-worker minibatch of pairs
    lam: float = 1.0
    margin: float = 1.0
    steps_per_worker: int = 200     # local computing iterations per worker
    server_batch: int = 4           # grad messages aggregated per server update
    seed: int = 0


def _stream(device: torch.device):
    """A CUDA stream of its own for a thread on the card; None on the CPU."""
    return torch.cuda.Stream(device=device) if device.type == "cuda" else None


def _send(x: torch.Tensor, stream):
    """A message: ``x`` and the event that marks the end of the work that
    wrote it on ``stream`` (None on the CPU)."""
    if stream is None:
        return x, None
    ready = torch.cuda.Event()
    ready.record(stream)
    return x, ready


def _receive(msg, stream) -> torch.Tensor:
    """A message's tensor, safe to read on ``stream``: the stream waits for
    the producer's event and the allocator keeps the block until the work
    queued on ``stream`` is done."""
    x, ready = msg
    if stream is not None:
        stream.wait_event(ready)
        x.record_stream(stream)
    return x


class _Thread:
    """A daemon thread that issues its device work on a stream of its own
    (``stream``, None on the CPU) and keeps its exception in ``error``."""

    def __init__(self, target, device: torch.device):
        self.error: Optional[BaseException] = None
        self.stream = _stream(device)
        self._target = target
        self.thread = threading.Thread(target=self._main, daemon=True)

    def _main(self):
        try:
            with torch.cuda.stream(self.stream):
                self._target()
        except Exception as err:        # raised again by run_async_dml
            self.error = err

    def start(self):
        self.thread.start()


class _Server(_Thread):
    """Central server: global L + inbound gradient queue + broadcast."""

    def __init__(self, L0: torch.Tensor, cfg: AsyncPSConfig,
                 worker_inboxes: List["queue.Queue"]):
        super().__init__(self._run, L0.device)
        self.L = L0
        self.cfg = cfg
        self.inbound: "queue.Queue" = queue.Queue()
        self.worker_inboxes = worker_inboxes
        self.n_updates = 0
        self.max_queue = 0              # deepest inbound queue it found
        self._stop = threading.Event()

    def _run(self):
        cfg = self.cfg
        while not self._stop.is_set() or not self.inbound.empty():
            msgs = []
            try:
                msgs.append(self.inbound.get(timeout=0.05))
            except queue.Empty:
                continue
            self.max_queue = max(self.max_queue, 1 + self.inbound.qsize())
            # batch whatever else is already queued (paper: update thread
            # "takes a batch of gradient updates from the inbound queue")
            while len(msgs) < cfg.server_batch:
                try:
                    msgs.append(self.inbound.get_nowait())
                except queue.Empty:
                    break
            grads = [_receive(m, self.stream) for m in msgs]
            # the reference's np.mean over axis 0: a sequential sum, then
            # one division
            g = grads[0]
            for h in grads[1:]:
                g = g + h
            g = g / len(grads)
            self.L = self.L - cfg.lr * g
            self.n_updates += 1
            fresh = _send(self.L, self.stream)
            for inbox in self.worker_inboxes:
                # drop stale broadcast if the worker hasn't consumed it yet —
                # best-effort semantics, the freshest parameter wins
                try:
                    inbox.get_nowait()
                except queue.Empty:
                    pass
                inbox.put(fresh)

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=30)


def _make_grad_fn(lam: float, margin: float):
    def grad_fn(L, xs, ys, sim):
        return dml.objective_value_and_grad(L, xs, ys, sim, lam, margin)
    return grad_fn


class _Worker(_Thread):
    """A worker on its own batch stream (``batches``: worker w's stream of
    ``make_worker_streams``, seeded ``cfg.seed + 1000 + w``)."""

    def __init__(self, wid: int, L0: torch.Tensor, batches,
                 cfg: AsyncPSConfig, server: _Server, inbox: "queue.Queue",
                 grad_fn: Callable, loss_trace: list,
                 trace_lock: threading.Lock, t0: float):
        super().__init__(self._run, L0.device)
        self.wid = wid
        self.L = L0
        self.batches = batches
        self.cfg = cfg
        self.server = server
        self.inbox = inbox
        self.grad_fn = grad_fn
        self.loss_trace = loss_trace
        self.trace_lock = trace_lock
        self.t0 = t0

    def _run(self):
        cfg = self.cfg
        for _ in range(cfg.steps_per_worker):
            # opportunistic pull of the freshest broadcast (remote update
            # thread in the paper); never blocks
            try:
                self.L = _receive(self.inbox.get_nowait(), self.stream)
            except queue.Empty:
                pass
            b = next(self.batches)
            loss, g = self.grad_fn(self.L, b["xs"], b["ys"], b["sim"])
            # local apply (compute thread keeps moving even if server is slow)
            self.L = self.L - cfg.lr * g
            self.server.inbound.put(_send(g, self.stream))
            loss = float(loss)
            with self.trace_lock:
                self.loss_trace.append((time.perf_counter() - self.t0,
                                        self.wid, loss))

    def join(self):
        self.thread.join(timeout=600)


def run_async_dml(cfg: AsyncPSConfig, pairs, L0, device=None,
                  stats: Optional[dict] = None):
    """Run the threaded async PS end to end.

    ``pairs`` is a pair dict or a pluggable pair source
    (``trainer.make_worker_streams``); ``L0`` a numpy array or a tensor
    (carried across as the trainer does). Runs on the card unless
    ``device="cpu"``. If ``stats`` is a dict it receives ``n_updates``,
    ``max_queue`` (the deepest inbound queue the server found) and
    ``messages``.

    Returns (final L, trace) where trace is a list of
    (wall_seconds, worker_id, minibatch_loss) tuples ordered by arrival.
    Raises the first exception a worker or the server raised, and raises
    if a thread did not finish.
    """
    dev = resolve_device(device)
    full_f32()                  # process-global: before any thread starts
    P, B = cfg.n_workers, cfg.batch_size
    if not torch.is_tensor(L0):
        L0 = torch.from_numpy(np.array(L0, copy=True))
    L0 = L0.to(device=dev, dtype=torch.float32)
    streams = make_worker_streams(pairs, P, B, seed=cfg.seed + 1000,
                                  device=dev)
    grad_fn = _make_grad_fn(cfg.lam, cfg.margin)
    # one warm-up gradient so first-call costs (cuBLAS handles, autograd)
    # do not pollute the trace's clock
    b0 = next(make_worker_streams(pairs, P, B, seed=cfg.seed,
                                  device=dev)[0])
    float(grad_fn(L0, b0["xs"], b0["ys"], b0["sim"])[0])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)     # L0 and the data, for every stream

    inboxes = [queue.Queue(maxsize=1) for _ in range(P)]
    server = _Server(L0, cfg, inboxes)
    trace: list = []
    lock = threading.Lock()
    t0 = time.perf_counter()
    workers = [
        _Worker(w, L0, streams[w], cfg, server, inboxes[w], grad_fn, trace,
                lock, t0)
        for w in range(P)
    ]
    server.start()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    server.stop()
    for t in workers + [server]:
        if t.error is not None:
            raise t.error
    alive = [t for t in workers + [server] if t.thread.is_alive()]
    if alive:
        raise RuntimeError(f"{len(alive)} async PS thread(s) did not finish")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)     # the server stream's last update
    if stats is not None:
        stats.update(n_updates=server.n_updates, max_queue=server.max_queue,
                     messages=len(trace))
    return server.L, trace
