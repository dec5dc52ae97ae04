"""``parallel/health.run_with_deadline``: the dispatch thread the streaming
CLI runs each batch on. One daemon thread per calling thread serves its
calls in turn, so per-thread state (cuDNN's execution plans) is built once;
a call past its deadline abandons that thread and the next call gets a
fresh one."""

import threading

import pytest

from vsc_tpu_torch.parallel import health


def _thread():
    return threading.current_thread()


def test_calls_share_one_dispatch_thread():
    first = health.run_with_deadline(_thread, 30)
    assert first is not threading.current_thread()
    assert first.name == "vsc-dispatch" and first.daemon
    assert all(health.run_with_deadline(_thread, 30) is first
               for _ in range(3))


def test_each_calling_thread_has_its_own_dispatch_thread():
    got = []
    t = threading.Thread(target=lambda: got.append(
        [health.run_with_deadline(_thread, 30) for _ in range(2)]))
    t.start()
    t.join()
    mine = health.run_with_deadline(_thread, 30)
    assert got[0][0] is got[0][1] and got[0][0] is not mine


def test_values_and_exceptions_reach_the_caller():
    assert health.run_with_deadline(lambda: 41 + 1, 30) == 42

    class Boom(Exception):
        pass

    def boom():
        raise Boom("from the dispatch thread")
    with pytest.raises(Boom, match="from the dispatch thread"):
        health.run_with_deadline(boom, 30)
    # the thread serves on after an exception
    assert health.run_with_deadline(lambda: "after", 30) == "after"


def test_a_wedged_call_times_out_and_the_next_runs_on_a_fresh_thread():
    release = threading.Event()
    wedged = health.run_with_deadline(_thread, 30)

    def hang():
        release.wait(30)
    try:
        with pytest.raises(TimeoutError, match="deadline"):
            health.run_with_deadline(hang, 0.2)
        fresh = health.run_with_deadline(_thread, 30)
        assert fresh is not wedged and fresh.is_alive()
        assert health.run_with_deadline(_thread, 30) is fresh
    finally:
        release.set()
