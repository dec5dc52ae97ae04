"""
Host <-> device pipelining
==========================

Port of ``vsc_tpu/io/prefetch.py``: bounded-queue loader/compute/saver
pipelining for the depth and SBS steps, generalizing the reference's
three-thread pattern (reference depth_map_generator.py:366-445,
sbs_generator.py:216-300) to *batches*: the loader assembles [B, ...]
numpy batches (so the device step is one dense dispatch, not B
single-frame calls), the device double-buffers (enqueue batch k+1 while k
computes), and the saver thread owns all disk writes with the reference's
retry-3x/60s-then-block-or-exit semantics.

The double buffer rests on ``compute`` returning before the device has
finished: torch's kernel launches are asynchronous, so ``compute`` must
not synchronize the device or read a value off it (no
``torch.cuda.synchronize()``, no ``.item()``); ``split_results``' copy to
the host (``.cpu()``) is where the main thread waits for batch k, after
batch k+1 was launched.
"""

from __future__ import annotations

import threading
import time
from queue import Queue
from typing import Any, Callable, Iterable

__all__ = ["run_pipeline", "SaveError", "PipelineAbort"]


class SaveError(RuntimeError):
    """Raised (in non-interactive mode) when an output cannot be written."""


class PipelineAbort(Exception):
    """Raise from compute() to stop the pipeline cleanly (drains the save
    queue, returns the done-count; unlike KeyboardInterrupt it is not
    re-raised)."""


def run_pipeline(
    items: Iterable[Any],
    load_batch: Callable[[list[Any]], Any],
    compute: Callable[[Any], Any],
    save_one: Callable[[Any], bool],
    split_results: Callable[[Any, list[Any]], list[Any]],
    batch_size: int = 1,
    interactive: bool = True,
    progress_cb: Callable[[int], None] | None = None,
    retries: int = 3,
    retry_sleep: float = 60.0,
) -> int:
    """Run the loader -> compute -> saver pipeline.

    Args:
      items: work items (paths / descriptors), consumed in order.
      load_batch: list of items -> host batch (called on loader thread).
      compute: host batch -> device result (called on main thread; should
        return quickly: torch launches kernels asynchronously).
      save_one: per-output callable returning success (saver thread).
      split_results: (computed batch, items) -> list of per-item outputs
        passed to save_one (main thread; may block on device transfer).
      batch_size: frames per device dispatch.
      interactive: False -> abort on persistent save failure (the
        orchestrator's --no-interactive contract).
      progress_cb: called with #items completed increments.
      retries/retry_sleep: save retry policy (reference: 3x / 60 s).

    Returns number of items fully processed.
    """
    items = list(items)
    load_q: Queue = Queue(maxsize=2)
    save_q: Queue = Queue(maxsize=max(4, 2 * batch_size))
    stop = threading.Event()
    save_failed = threading.Event()

    def loader():
        for i in range(0, len(items), batch_size):
            if stop.is_set():
                break
            chunk = items[i:i + batch_size]
            try:
                load_q.put((chunk, load_batch(chunk)))
            except Exception as e:  # corrupt input: report, keep going
                print(f"  Error loading batch at item {i}: {e}")
        load_q.put(None)

    def saver():
        while True:
            entry = save_q.get()
            if entry is None:
                save_q.task_done()
                break
            # Reference retry contract (depth_map_generator.py:399-437):
            # N attempts with sleeps; in interactive mode block on Enter and
            # RETRY the same item; never silently drop an output.
            ok = False
            while not ok and not stop.is_set():
                for attempt in range(retries):
                    try:
                        if save_one(entry):
                            ok = True
                            break
                        raise IOError("writer returned failure")
                    except Exception as e:
                        print(f"\nSave failed ({attempt + 1}/{retries}): {e}")
                        if attempt < retries - 1:
                            time.sleep(retry_sleep)
                if ok:
                    break
                save_failed.set()
                if not interactive:
                    print("\nERROR: Failed to write output. Exiting "
                          "(non-interactive mode).")
                    stop.set()
                    break
                print("\nERROR: Failed to write output.\n"
                      "Resolve the storage issue and press Enter to retry.")
                try:
                    input()
                except (EOFError, KeyboardInterrupt):
                    stop.set()
                    break
            if ok:
                save_failed.clear()
            save_q.task_done()

    lt = threading.Thread(target=loader, daemon=True)
    st = threading.Thread(target=saver, daemon=True)
    lt.start()
    st.start()

    done = 0
    pending = None  # (future_result, chunk) double-buffer slot
    try:
        while not stop.is_set():
            nxt = load_q.get()
            if nxt is None:
                break
            chunk, batch = nxt
            result = compute(batch)  # asynchronous launches: returns at once
            if pending is not None:
                _flush(pending, split_results, save_q)
                done += len(pending[1])
                if progress_cb:
                    progress_cb(len(pending[1]))
            pending = (result, chunk)
        if pending is not None and not stop.is_set():
            _flush(pending, split_results, save_q)
            done += len(pending[1])
            if progress_cb:
                progress_cb(len(pending[1]))
    except PipelineAbort:
        stop.set()
    except KeyboardInterrupt:
        print("\nInterrupted! Draining save queue...")
        stop.set()
        save_q.put(None)
        st.join(timeout=30)
        # Propagate: an interrupted step must NOT exit 0, or the
        # orchestrator would mark the half-finished step DONE.
        raise

    if not stop.is_set():
        save_q.join()
    save_q.put(None)
    st.join(timeout=30)
    if save_failed.is_set() and not interactive:
        raise SaveError("persistent save failure")
    return done


def _flush(pending, split_results, save_q):
    result, chunk = pending
    for out in split_results(result, chunk):
        save_q.put(out)
