"""The port test files' lowered CPU priority (tests/torch_port_helpers.py::
lowered_priority), which every port file's `one_torch_thread` fixture
enters before the file's first test.

A thread listed in /proc/self/task may end before its priority is read: a
test worker holds pools of earlier files (the loader's decode threads,
XLA's, gloo's) that end threads at any time. The helper read every listed
thread's priority without leaving such a thread out, and the
ProcessLookupError failed the setup of every test of the file it guarded
(all six of tests/test_torch_port_dist_zoos.py in one tier-1 run).

Time: under a second.
"""

import os
import threading

import torch_port_helpers
from torch_port_helpers import lowered_priority


def _nice(tid):
    return os.getpriority(os.PRIO_PROCESS, tid)


class _Sleeper:
    """A thread that waits until released, and its thread id."""

    def __init__(self):
        self.release = threading.Event()
        self.thread = threading.Thread(target=self.release.wait, daemon=True)
        self.thread.start()
        self.tid = self.thread.native_id

    def stop(self):
        self.release.set()
        self.thread.join()


def _ended_thread_id():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return t.native_id


def test_a_thread_that_ends_while_listed_is_left_out(monkeypatch):
    """A listed thread id whose thread has ended (its priority cannot be
    read) is left out; every live thread is still lowered and restored."""
    ended = _ended_thread_id()
    listed = torch_port_helpers._thread_ids
    monkeypatch.setattr(torch_port_helpers, "_thread_ids", lambda: listed() + [ended])
    sleeper = _Sleeper()
    try:
        before = _nice(sleeper.tid)
        with lowered_priority():
            assert _nice(sleeper.tid) == min(before + 19, 19)
        assert _nice(sleeper.tid) == before
    finally:
        sleeper.stop()


def test_every_thread_is_lowered_and_restored():
    """Each thread of the process, not only the caller, at +19 inside the
    block and back at its old priority after it."""
    sleepers = [_Sleeper() for _ in range(3)]
    tids = [threading.get_native_id()] + [s.tid for s in sleepers]
    try:
        before = {t: _nice(t) for t in tids}
        with lowered_priority():
            assert {t: _nice(t) for t in tids} == {t: min(n + 19, 19) for t, n in before.items()}
        assert {t: _nice(t) for t in tids} == before
    finally:
        for s in sleepers:
            s.stop()


def test_a_thread_started_inside_comes_back_to_normal():
    """A thread started inside the block inherits the lowered priority, and
    is set to the process's priority when the block ends."""
    normal = _nice(0)
    with lowered_priority():
        sleeper = _Sleeper()
        assert _nice(sleeper.tid) == min(normal + 19, 19)
    try:
        assert _nice(sleeper.tid) == normal
    finally:
        sleeper.stop()
