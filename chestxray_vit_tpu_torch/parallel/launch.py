"""One process driving several devices: the port's launcher.

The JAX package trains on every local device from one process: one
``jit`` over one mesh (``chestxray_vit_tpu/parallel/mesh.py``), as the
reference forked one process a core with ``xmp.spawn``. The port runs one
process a device, so a lone process that is given several devices starts
one rank a device here and joins them in a process group; every path the
ranks run is the one ``torchrun`` ranks run.

- :func:`train_devices` reads a ``device`` argument as the JAX package
  reads its devices: ``"cuda"`` is every visible card, ``"cuda:k"`` that
  card, ``"cpu"`` one CPU device, a sequence those devices, repeats
  allowed (two ranks on ``cuda:0``, four on the CPU: how one card and the
  CPU tests stand in for several devices).
- :class:`Ranks` starts the ranks with the ``spawn`` start method; they
  meet at a ``file://`` rendezvous in a temporary directory (no port to
  race for), in a group whose backend follows the placement
  (``distributed.backend_for``: NCCL with a card a rank, gloo where ranks
  share one or run on the CPU). Rank r builds ``factory(*args,
  device=devices[r], **kw)`` and then runs the calls relayed to it, in
  order; a call returns rank 0's value. ``notify`` reaches every rank at
  once, between the calls' steps (a stop request), and ``signal`` sends a
  signal to every rank.
- Rank 0's output goes to this process's stdout; every rank's output is
  kept in its log, whose tail comes with a rank's failure. An exception
  in a rank is raised here with its type and message, the rank's
  traceback and output tail as notes, and every rank is then stopped. No
  rank outlives this process: a rank whose pipe to it closes exits, also
  when this process was killed or never called :meth:`Ranks.close`.
- With a card among the devices, the kernel library is built here once,
  before any rank starts (n ranks that found none would each run every
  ``nvcc``); this process creates no CUDA context.
"""

from __future__ import annotations

import codecs
import functools
import multiprocessing as mp
import multiprocessing.connection as mpc
import os
import pickle
import queue
import shutil
import signal
import sys
import tempfile
import threading
import traceback
import weakref
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

# the bytes of a failed rank's output shown with its error
TAIL_BYTES = 4000
# seconds a closing rank gets to leave before it is killed
CLOSE_TIMEOUT_S = 60

_rank_dir: Optional[str] = None


def rank_directory() -> Optional[str]:
    """In a rank that :class:`Ranks` started, the ranks' temporary
    directory (their logs, removed when the ranks close); None
    elsewhere."""
    return _rank_dir


def train_devices(device) -> List[torch.device]:
    """The devices that ``device`` names, one rank each: ``"cuda"`` every
    visible card (``cuda:0`` … ``cuda:n-1``, as ``jax.devices()`` lists
    them), ``"cuda:k"`` that card alone, ``"cpu"`` one CPU device, a
    sequence those devices (repeats allowed; an unindexed card in it is
    ``cuda:0``). Cards asked for where there are none raise: nothing
    falls back to the CPU. Counting the cards creates no CUDA context."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if not devs:
            raise ValueError("device: an empty sequence of devices")
        if len({d.type for d in devs}) > 1:
            raise ValueError(f"device: devices of several types {devs}")
        devs = [torch.device("cuda", d.index or 0) if d.type == "cuda"
                else d for d in devs]
    else:
        d = torch.device(device)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if d.type == "cuda" and d.index is None else [d])
    if torch.device(devs[0] if devs else "cuda").type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not count:
            raise RuntimeError(f"device={device!r} but no CUDA device is "
                               f"available")
        missing = sorted({d.index for d in devs if d.index >= count})
        if missing:
            raise ValueError(f"device={device!r}: no card {missing} among "
                             f"the {count} visible")
    return devs


def _payload(what: str, factory, args: tuple, kw: dict) -> bytes:
    """The construction pickled once for every rank; an argument that
    cannot be pickled is refused here, by name, before any rank starts."""
    errors = (pickle.PicklingError, TypeError, AttributeError)
    try:
        return pickle.dumps((factory, args, kw))
    except errors:
        pass
    named = ([("the class", factory)]
             + [(f"argument {i}", a) for i, a in enumerate(args)]
             + [(k, v) for k, v in kw.items()])
    for name, value in named:
        try:
            pickle.dumps(value)
        except errors as e:
            raise TypeError(f"{what} starts one process a device and sends "
                            f"each its arguments: {name} "
                            f"({type(value).__name__}) cannot be pickled: "
                            f"{e}") from None
    raise TypeError(f"{what}: its arguments cannot be pickled together")


def _error(e: BaseException) -> tuple:
    """A rank's exception as a reply: the exception pickled where it can
    be, with its type, message and traceback as text."""
    try:
        blob = pickle.dumps(e)
    except Exception:       # noqa: BLE001 — any exception reaches the caller
        blob = None
    return ("error", blob, type(e).__name__, str(e),
            "".join(traceback.format_exception(e)))


def _listen(conn, commands: queue.Queue, holder: dict) -> None:
    """A rank's reader of the caller's pipe: calls go to the main thread in
    order, a notification runs at once (``request_stop`` only sets a flag).
    The pipe's end is the caller's: the rank exits at once."""
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            os._exit(1)
        if msg[0] == "notify":
            if "obj" in holder:
                getattr(holder["obj"], msg[1])()
            continue
        commands.put(msg)
        if msg[0] == "exit":
            return


def _rank_main(rank: int, devices: List[torch.device], conn,
               directory: str, threads: int) -> None:
    """One rank: its output to its log, a group over ``devices`` met at a
    file in ``directory``, the object built from the first message, then
    the relayed calls."""
    global _rank_dir
    _rank_dir = directory
    # the caller forwards the signals it is sent; a terminal's signal to
    # its process group reaches the caller alone
    os.setpgrp()
    log = os.open(os.path.join(directory, f"rank{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_APPEND)
    os.dup2(log, 1)
    os.dup2(log, 2)
    sys.stdout.reconfigure(line_buffering=True)
    sys.stderr.reconfigure(line_buffering=True)
    device = devices[rank]
    if device.type == "cpu":
        torch.set_num_threads(threads)

    def reply(msg) -> None:
        conn.send_bytes(pickle.dumps(msg))

    payload = conn.recv_bytes()
    commands: queue.Queue = queue.Queue()
    holder: dict = {}
    threading.Thread(target=_listen, args=(conn, commands, holder),
                     daemon=True).start()
    from chestxray_vit_tpu_torch.parallel import distributed as dist
    try:
        dist.initialize(f"file://{os.path.join(directory, 'rendezvous')}",
                        len(devices), rank, device=device, placement=devices)
        factory, args, kw = pickle.loads(payload)
        holder["obj"] = (factory(*args, device=device, **kw)
                         if factory is not None else device)
        reply(("ok", None))
    except BaseException as e:      # noqa: BLE001 — reported to the caller
        reply(_error(e))
        return
    obj = holder["obj"]
    while True:
        msg = commands.get()
        if msg[0] == "exit":
            break
        _, target, args, kw = msg
        try:
            fn = (getattr(obj, target) if isinstance(target, str)
                  else functools.partial(target, obj))
            value = fn(*args, **kw)
            reply(("ok", value if rank == 0 else None))
        except BaseException as e:  # noqa: BLE001 — reported to the caller
            reply(_error(e))
    if dist.is_initialized():
        torch.distributed.destroy_process_group()


def _stop(procs: list, conns: list, directory: str) -> None:
    """Kill every rank still running and remove the ranks' directory."""
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()
    for conn in conns:
        conn.close()
    shutil.rmtree(directory, ignore_errors=True)


class Ranks:
    """``len(devices)`` ranks, rank r building ``factory(*args,
    device=devices[r], **kw)`` (``factory`` None: the rank's object is its
    device) in one process group, started at once; :meth:`call` relays to
    every rank and returns rank 0's value. ``what`` names the construction
    in messages."""

    def __init__(self, devices: Sequence, factory: Optional[Callable] = None,
                 args: tuple = (), kw: Optional[dict] = None,
                 what: str = "the ranks"):
        self.devices = [torch.device(d) for d in devices]
        self.what = what
        payload = _payload(what, factory, tuple(args), dict(kw or {}))
        if any(d.type == "cuda" for d in self.devices):
            from chestxray_vit_tpu_torch import kernels
            kernels.build()
        n = len(self.devices)
        self.directory = tempfile.mkdtemp(prefix="cxr_ranks_")
        ctx = mp.get_context("spawn")
        threads = max(1, torch.get_num_threads() // n)
        self._procs, self._conns = [], []
        for r in range(n):
            ours, theirs = ctx.Pipe()
            p = ctx.Process(target=_rank_main, name=f"cxr-rank{r}",
                            args=(r, self.devices, theirs, self.directory,
                                  threads), daemon=True)
            p.start()
            theirs.close()
            self._procs.append(p)
            self._conns.append(ours)
        # a Ranks dropped or left at exit without close() stops its ranks
        self._finalizer = weakref.finalize(
            self, _stop, self._procs, self._conns, self.directory)
        self._owed = [1] * n           # the construction's replies
        self._send_lock = threading.Lock()
        self._call_lock = threading.Lock()
        self._out_pos = 0
        self._decoder = codecs.getincrementaldecoder("utf-8")("replace")
        self.alive = True
        # after every start: a start returns once its rank has read what
        # it was sent, so the construction goes by the pipes, which the
        # ranks read when they have all started
        for conn in self._conns:
            conn.send_bytes(payload)

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def call(self, target: Union[str, Callable], *args, **kw) -> Any:
        """Run ``getattr(obj, target)(*args, **kw)`` (or ``target(obj,
        *args, **kw)`` for a picklable function) on every rank; rank 0's
        value."""
        with self._call_lock:
            self._check_alive()
            self._send(("call", target, args, kw))
            return self._gather()

    def notify(self, name: str) -> None:
        """Call ``obj.<name>()`` on every rank at once, beside a running
        call (from the ranks' reader threads)."""
        self._check_alive()
        self._send(("notify", name))

    def signal(self, signum: int) -> None:
        """Send ``signum`` to every rank."""
        for p in self._procs:
            if p.is_alive():
                os.kill(p.pid, signum)

    def close(self) -> None:
        """Let every rank leave (after what it runs), show rank 0's last
        output, kill what is left and remove the ranks' directory."""
        if not self.alive:
            return
        self.alive = False
        with self._send_lock:
            for conn in self._conns:
                try:
                    conn.send_bytes(pickle.dumps(("exit",)))
                except OSError:
                    pass
        for p in self._procs:
            p.join(CLOSE_TIMEOUT_S)
        self._pump()
        self._finalizer()

    # -- the caller's side --------------------------------------------------

    def _check_alive(self) -> None:
        if not self.alive:
            raise RuntimeError(f"{self.what}: the ranks have stopped")

    def _send(self, msg) -> None:
        blob = pickle.dumps(msg)
        with self._send_lock:
            for r, conn in enumerate(self._conns):
                conn.send_bytes(blob)
                if msg[0] == "call":
                    self._owed[r] += 1

    def _pump(self) -> None:
        """Copy what rank 0 wrote since the last pump to stdout."""
        path = os.path.join(self.directory, "rank0.log")
        try:
            with open(path, "rb") as f:
                f.seek(self._out_pos)
                data = f.read()
        except FileNotFoundError:
            return
        if data:
            self._out_pos += len(data)
            sys.stdout.write(self._decoder.decode(data))
            sys.stdout.flush()

    def _tail(self, rank: int) -> str:
        try:
            with open(os.path.join(self.directory, f"rank{rank}.log"),
                      "rb") as f:
                f.seek(max(os.path.getsize(f.name) - TAIL_BYTES, 0))
                return f.read().decode("utf-8", "replace")
        except FileNotFoundError:
            return ""

    def _gather(self) -> Any:
        """Wait until every rank has answered all it owes; rank 0's last
        value. A rank's error, or its exit before it answered, stops every
        rank and raises here."""
        value = None
        try:
            waiting = {r for r, owed in enumerate(self._owed) if owed}
            while waiting:
                mpc.wait([self._conns[r] for r in waiting]
                         + [self._procs[r].sentinel for r in waiting], 0.2)
                self._pump()
                for r in sorted(waiting):
                    conn = self._conns[r]
                    while self._owed[r] and conn.poll():
                        try:
                            msg = pickle.loads(conn.recv_bytes())
                        except (EOFError, OSError):     # the rank is gone
                            self._fail(r, None)
                        self._owed[r] -= 1
                        if msg[0] == "error":
                            self._fail(r, msg)
                        if r == 0:
                            value = msg[1]
                    if not self._owed[r]:
                        waiting.discard(r)
                    elif not self._procs[r].is_alive() and not conn.poll():
                        self._fail(r, None)
        except BaseException:
            # a rank's error, or this process interrupted mid-call: the
            # ranks' state is unknown, so none of them goes on
            if self.alive:
                self.alive = False
                self._pump()
                self._finalizer()
            raise
        self._pump()
        return value

    def _fail(self, rank: int, msg) -> None:
        """Raise rank ``rank``'s error (``msg``; None: it exited without
        one) after every rank is stopped."""
        self.alive = False
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join()
        self._pump()
        where = f"rank {rank} of {len(self._procs)} ({self.devices[rank]})"
        if msg is None:
            exc: BaseException = RuntimeError(
                f"{self.what}: {where} exited with code "
                f"{self._procs[rank].exitcode} before it answered")
        else:
            _, blob, name, text, tb = msg
            try:
                exc = pickle.loads(blob) if blob is not None else None
            except Exception:   # noqa: BLE001 — fall back to the text
                exc = None
            if not isinstance(exc, BaseException):
                exc = RuntimeError(f"{name}: {text}")
            exc.add_note(f"raised in {where}:\n{tb.rstrip()}")
        exc.add_note(f"the output of {where} ended:\n{self._tail(rank)}")
        self._finalizer()
        raise exc


def forward_signals(ranks: Ranks) -> Callable[[], None]:
    """Forward SIGTERM and SIGINT sent to this process to every rank while
    it waits on them (from the main thread only); returns the restore
    callback."""
    if threading.current_thread() is not threading.main_thread():
        return lambda: None
    previous = {}

    def forward(signum, frame):
        print(f"[launch] signal {signum}: forwarded to the ranks")
        ranks.signal(signum)

    for sig in (signal.SIGTERM, signal.SIGINT):
        previous[sig] = signal.signal(sig, forward)

    def restore():
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return restore
