"""The training loader's producer process: :class:`TreeLoader` batches made
one process over, ahead of the step that consumes them.

:class:`BatchProducer` starts one child process, a fresh interpreter (the
consumer has threads and a CUDA context, which a forked child would share),
and sends it the loader, its generators as they stand, on its standard
input.  Unlike ``multiprocessing``'s ``spawn``, the child does not import the
consumer's main module, so a script without a ``__main__`` guard keeps
working.  The child runs the loader's own batch generator
(``TreeLoader._batches``) epoch after epoch, at most ``PREFETCH`` batches
ahead of the consumer: the consumer returns one credit for each batch it
takes.  The child imports the loader's modules and numpy, and neither torch
nor anything that calls CUDA.

Each array of a batch crosses in a slot: a shared-memory file
(``memfd_create``) that both processes keep mapped.  A slot's descriptor
goes over a Unix socket once, with the first batch that uses it; after
that a batch's header names its slots.  The consumer hands out each array
as a view of its slot's mapping and owns it: the slot stays the array's
for as long as the array, or any view of it, lives, and only then does the
consumer report it free, with its next credit, for the child to fill again.
So a slot is never written under a live batch, a kept batch costs its own
slots and no more, and in the steady state no page is mapped, faulted or
freed a batch.  The child keeps up to ``MAX_FREE_SLOTS`` free slots and
drops the rest.  Nothing is pickled but the header: the batch's other
entries, the states of the loader's and the dataset's generators right
after the batch was made, and the host milliseconds of the batch's parts
(the spans ``loader.batch``, ``loader.read``, ``loader.augment``,
``loader.offsets`` and ``loader.collate``, taken in the child by a
:class:`SpanTimer`), which the consumer counts as ``loader.<part>_us`` on
receipt.  The consumer's receive is the span ``loader.wait``; the counters
``loader.ready`` and ``loader.waited`` say whether the batch was already
there when it was asked for.

An exception in the child is raised in the consumer, with its type and
message, when the consumer asks for the batch that failed.  A child that
ends without a word closes its end of the socket, and the consumer raises.
The child exits when the consumer's end closes.
"""

from __future__ import annotations

import collections
import mmap
import os
import pickle
import select
import signal
import socket
import subprocess
import sys
import traceback
import weakref

import numpy as np

from ..utils.trace import SpanTimer, count, span

PREFETCH = 2            # batches the producer makes ahead of the consumer
MAX_HEADER = 1 << 16    # bytes of one header, pickled
MAX_ARRAYS = 64         # arrays of one batch (descriptors of one message)
MAX_FREE_SLOTS = 40     # free slots the producer keeps: ~3 batches' arrays
STOP_S = 5.0            # seconds a stopped producer gets to end


def _write_all(fd: int, arr: np.ndarray) -> None:
    view = memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
    pos = 0
    while pos < len(view):
        pos += os.pwrite(fd, view[pos:], pos)


class _Slots:
    """The child's slots: {id: (descriptor, bytes)}, and the free ones."""

    def __init__(self):
        self.slots = {}
        self.free = []
        self.next_id = 0

    def release(self, ids) -> None:
        self.free.extend(ids)

    def fill(self, arr: np.ndarray, new: list) -> int:
        """A free slot of at least ``arr``'s bytes (the smallest), or a new
        one (appended to ``new``), written with ``arr``; its id."""
        fits = [i for i in self.free if self.slots[i][1] >= arr.nbytes]
        if fits:
            sid = min(fits, key=lambda i: self.slots[i][1])
            self.free.remove(sid)
        else:
            sid, self.next_id = self.next_id, self.next_id + 1
            fd = os.memfd_create("treelearn-batch", os.MFD_CLOEXEC)
            os.ftruncate(fd, arr.nbytes)
            self.slots[sid] = (fd, arr.nbytes)
            new.append(sid)
        _write_all(self.slots[sid][0], arr)
        return sid

    def trim(self) -> list:
        """Drop the free slots beyond ``MAX_FREE_SLOTS``; their ids."""
        drop = self.free[MAX_FREE_SLOTS:]
        del self.free[MAX_FREE_SLOTS:]
        for sid in drop:
            os.close(self.slots.pop(sid)[0])
        return drop


def _send_batch(sock, batch: dict, loader, timer: SpanTimer,
                slots: _Slots) -> None:
    new, arrays = [], []
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            sid = slots.fill(v, new) if v.nbytes else None
            arrays.append((k, v.dtype, v.shape, sid))
    assert len(new) <= MAX_ARRAYS, len(new)
    header = {
        "keys": list(batch),
        "arrays": arrays,
        "new": [(sid, slots.slots[sid][1]) for sid in new],
        "drop": slots.trim(),
        "other": {k: v for k, v in batch.items()
                  if not isinstance(v, np.ndarray)},
        "states": (loader.rng.bit_generator.state,
                   loader.dataset.rng.bit_generator.state),
        "parts_ms": {name: row[1] for name, row in timer.summary().items()},
    }
    socket.send_fds(sock, [pickle.dumps(header)],
                    [slots.slots[sid][0] for sid in new])


def _send_error(sock, exc: BaseException) -> None:
    """Tell the consumer of ``exc``: the exception itself where it pickles,
    else a RuntimeError naming it; the child's traceback beside it."""
    text = "".join(traceback.format_exception(exc))[-MAX_HEADER // 4:]
    try:
        msg = pickle.dumps({"error": exc, "traceback": text})
        pickle.loads(msg)
    except Exception:
        msg = b""
    if not msg or len(msg) > MAX_HEADER:
        msg = pickle.dumps({"error": RuntimeError(
            f"{type(exc).__name__}: {str(exc)[:1000]}"), "traceback": text})
    try:
        sock.send(msg)
    except OSError:             # the consumer is gone
        pass


def _read_notes(sock, slots: _Slots, block: bool) -> int:
    """The consumer's notes (credits, then the ids of freed slots) that
    have come, waiting for one if ``block``: the credits, or -1 when the
    consumer is gone."""
    credits = 0
    flags = 0 if block else socket.MSG_DONTWAIT
    while True:
        try:
            got = sock.recv(MAX_HEADER, flags)
        except BlockingIOError:
            return credits
        if not got:
            return -1
        note = np.frombuffer(got, np.int32)
        credits += int(note[0])
        slots.release(note[1:].tolist())
        flags = socket.MSG_DONTWAIT


def _child(fd: int) -> None:
    """The child: the loader from standard input, then its epochs, batch
    after batch, as credits come, on the socket ``fd``."""
    signal.signal(signal.SIGINT, signal.SIG_IGN)    # the consumer stops it
    sock = socket.socket(fileno=fd)
    slots = _Slots()
    credits = PREFETCH
    try:
        loader = pickle.load(sys.stdin.buffer)
        while True:
            batches = loader._batches()
            while True:
                got = _read_notes(sock, slots, block=credits == 0)
                if got < 0:                         # the consumer is gone
                    return
                credits += got
                if credits == 0:
                    continue
                with SpanTimer("cpu") as timer:
                    batch = next(batches, None)
                if batch is None:
                    break
                _send_batch(sock, batch, loader, timer, slots)
                credits -= 1
    except (BrokenPipeError, ConnectionResetError):
        return                                      # the consumer is gone
    except Exception as exc:    # the boundary: the consumer raises it
        _send_error(sock, exc)
    finally:
        sock.close()


def _stop(proc, sock) -> None:
    sock.close()
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(STOP_S)
        except subprocess.TimeoutExpired:
            proc.kill()
    proc.wait()


def _map(fd: int, nbytes: int) -> mmap.mmap:
    try:
        return mmap.mmap(fd, nbytes,
                         flags=mmap.MAP_SHARED | mmap.MAP_POPULATE)
    finally:
        os.close(fd)


class BatchProducer:
    """One producer process of ``loader`` (see the module docstring), from
    its generators' states now.  :meth:`receive` takes the next batch;
    :meth:`close`, or collecting this object, ends the process.  Batches
    handed out stay valid after either."""

    def __init__(self, loader):
        self._maps = {}                      # slot id -> our mapping
        self._freed = collections.deque()    # slot ids to report free
        ours, theirs = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
        path = [p for p in sys.path if isinstance(p, str)]
        code = (f"import sys; sys.path[:0] = {path!r}; "
                f"from {__name__} import _child; _child({theirs.fileno()})")
        try:
            proc = subprocess.Popen([sys.executable, "-c", code],
                                    stdin=subprocess.PIPE,
                                    pass_fds=(theirs.fileno(),))
        except BaseException:
            ours.close()
            raise
        finally:
            theirs.close()
        self.sock, self.proc = ours, proc
        self._stop = weakref.finalize(self, _stop, proc, ours)
        try:
            with proc.stdin:
                pickle.dump(loader, proc.stdin)
        except BrokenPipeError:     # the child ended: receive() says how
            pass

    def _view(self, sid, dtype, shape) -> np.ndarray:
        """An array on slot ``sid``; the slot is reported free once it and
        every view of it are gone."""
        if sid is None:
            return np.empty(shape, dtype)
        n = int(np.prod(shape, dtype=np.int64))
        owner = np.frombuffer(self._maps[sid], dtype, count=n)
        weakref.finalize(owner, self._freed.append, sid)
        return owner.reshape(shape)

    def _note(self) -> None:
        """One credit and the slots freed since the last note."""
        freed = []
        while self._freed:
            freed.append(self._freed.popleft())
        try:
            self.sock.send(np.asarray([1] + freed, np.int32).tobytes())
        except OSError:     # the child has ended: the next receive reads
            pass            # its error or its end

    def receive(self):
        """(batch, (loader state, dataset state)) of the next batch; raises
        the producer's exception if making it failed."""
        ready = bool(select.select([self.sock], [], [], 0)[0])
        count("loader.ready" if ready else "loader.waited")
        with span("loader.wait"):
            msg, fds, _, _ = socket.recv_fds(self.sock, MAX_HEADER,
                                             MAX_ARRAYS)
            header = pickle.loads(msg) if msg else None
            if header is None or "error" in header:
                for fd in fds:
                    os.close(fd)
            else:
                for (sid, nbytes), fd in zip(header["new"], fds):
                    self._maps[sid] = _map(fd, nbytes)
                for sid in header["drop"]:
                    del self._maps[sid]
                arrays = {k: self._view(sid, dtype, shape)
                          for k, dtype, shape, sid in header["arrays"]}
                self._note()
        if header is None:
            try:
                code = self.proc.wait(STOP_S)
            except subprocess.TimeoutExpired:
                code = None
            raise RuntimeError("the loader's producer process ended "
                               f"(exit code {code})")
        if "error" in header:
            raise header["error"] from RuntimeError(
                "in the producer process:\n" + header["traceback"])
        for name, ms in header["parts_ms"].items():
            count(f"{name}_us", round(ms * 1e3))
        batch = {k: arrays[k] if k in arrays else header["other"][k]
                 for k in header["keys"]}
        return batch, header["states"]

    def close(self) -> None:
        self._stop()
