"""The port's loader / compute / saver pipeline (vsc_tpu_torch/io/prefetch)
holds the JAX package's contract (vsc_tpu/io/prefetch.py): order kept over
ragged batches, a batch that fails to load reported and skipped, saves
retried and then raised (non-interactive), PipelineAbort drained and
counted, KeyboardInterrupt re-raised, and compute for batch k+1 called
before split_results of batch k (the double buffer). Each case runs on
both packages' run_pipeline and must give the same outcome."""

import threading

import pytest

from vsc_tpu.io import prefetch as jax_prefetch
from vsc_tpu_torch.io import prefetch as torch_prefetch

MODULES = pytest.mark.parametrize("mod", [jax_prefetch, torch_prefetch],
                                  ids=["jax", "torch"])


def _run(mod, items, *, load_batch=None, compute=None, save_one=None,
         batch_size=3, **kw):
    saved, lock = [], threading.Lock()

    def default_save(x):
        with lock:
            saved.append(x)
        return True

    done = mod.run_pipeline(
        items, load_batch or (lambda chunk: list(chunk)),
        compute or (lambda batch: [2 * x for x in batch]),
        save_one or default_save,
        lambda result, chunk: result[:len(chunk)],
        batch_size=batch_size, interactive=False, retry_sleep=0, **kw)
    return done, saved


@MODULES
def test_order_and_count_over_ragged_batches(mod):
    progress = []
    done, saved = _run(mod, range(10), progress_cb=progress.append)
    assert done == 10
    assert saved == [2 * i for i in range(10)]      # one saver: in order
    assert progress == [3, 3, 3, 1]


@MODULES
def test_load_error_is_reported_and_skipped(mod, capsys):
    def load_batch(chunk):
        if 3 in chunk:
            raise IOError("corrupt frame")
        return list(chunk)
    done, saved = _run(mod, range(8), load_batch=load_batch)
    assert done == 5
    assert saved == [0, 2, 4, 12, 14]
    assert "Error loading batch at item 3: corrupt frame" in \
        capsys.readouterr().out


@MODULES
def test_two_save_failures_then_success(mod):
    attempts = []

    def save_one(x):
        attempts.append(x)
        return x != 4 or attempts.count(4) > 2
    done, _ = _run(mod, range(4), save_one=save_one, batch_size=2)
    assert done == 4
    assert attempts.count(4) == 3 and attempts.count(2) == 1


@MODULES
def test_persistent_save_failure_raises_when_not_interactive(mod):
    attempts = []

    def save_one(x):
        attempts.append(x)
        return x != 2
    with pytest.raises(mod.SaveError):
        _run(mod, range(6), save_one=save_one, batch_size=2, retries=3)
    assert attempts.count(2) == 3


@MODULES
def test_pipeline_abort_returns_the_done_count(mod):
    calls = []

    def compute(batch):
        calls.append(batch)
        if len(calls) == 3:
            raise mod.PipelineAbort("device lost")
        return [2 * x for x in batch]
    done, _ = _run(mod, range(12), compute=compute, batch_size=2)
    assert done == 2        # batch 0 flushed when batch 1 was launched


@MODULES
def test_keyboard_interrupt_is_reraised(mod):
    def compute(batch):
        if 4 in batch:
            raise KeyboardInterrupt
        return [2 * x for x in batch]
    with pytest.raises(KeyboardInterrupt):
        _run(mod, range(8), compute=compute, batch_size=2)


@MODULES
def test_compute_of_next_batch_precedes_split_of_previous(mod):
    events = []

    def compute(batch):
        events.append(("compute", batch[0]))
        return batch

    def split(result, chunk):
        events.append(("split", result[0]))
        return result

    done = mod.run_pipeline(range(6), list, compute, lambda x: True, split,
                            batch_size=2, interactive=False, retry_sleep=0)
    assert done == 6
    assert events == [("compute", 0), ("compute", 2), ("split", 0),
                      ("compute", 4), ("split", 2), ("split", 4)]
