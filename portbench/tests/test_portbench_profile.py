"""The traced slice keeps graph captures out of the profiler without
stalling them: a capture that asks for the program's capture lock ends the
slice, and waits only for the profiler to stop."""

import threading
import time

from portbench import profile


class _Owner:
    def __init__(self):
        self._capture_lock = threading.Lock()


def _fake_record(length, wanted):
    t0 = time.monotonic()
    wanted.wait(timeout=length)
    t1 = time.monotonic()
    return None, t0, t1


def _fake_read(_prof, t0, t1):
    us = (t1 - t0) * 1e6
    return {"t0": t0, "t1": t1, "window_s": t1 - t0,
            "kernels": [(0.0, us / 4, "chain_kernel<1>"), (us / 2, us * 3 / 4, "other")],
            "host": [(us / 2 - 1, us / 2, "cudaGraphLaunch")]}


def test_capture_ends_the_slice_and_waits_only_for_the_stop(monkeypatch):
    monkeypatch.setattr(profile, "_record", _fake_record)
    monkeypatch.setattr(profile, "_read", _fake_read)
    owner = _Owner()
    real = owner._capture_lock
    waited = []

    def capture():
        time.sleep(0.7)
        t = time.monotonic()
        with owner._capture_lock:  # the program's `with self._capture_lock:`
            waited.append(time.monotonic() - t)
            time.sleep(0.1)

    th = threading.Thread(target=capture)
    th.start()
    got = profile.profile_slice(1.0, owner)
    th.join()
    assert owner._capture_lock is real and not real.locked()
    assert got["guarded"] and got["cut_by_capture"] == 1
    assert 0.65 < got["window_s"] < 0.9
    assert waited[0] < 0.2 and 0 < got["longest_capture_wait_s"] < 0.2
    s = profile.summarize(got)
    assert abs(s["busy_s"] - got["window_s"] / 2) < 1e-6
    assert abs(s["parts"]["chain"] - got["window_s"] / 4) < 1e-6
    assert s["idle_gaps"][0][0] == "cudaGraphLaunch"


def test_uncut_slice_runs_its_length(monkeypatch):
    monkeypatch.setattr(profile, "_record", _fake_record)
    monkeypatch.setattr(profile, "_read", _fake_read)
    got = profile.profile_slice(0.3, _Owner())
    assert got["guarded"] and got["cut_by_capture"] == 0 and got["longest_capture_wait_s"] == 0.0
    assert got["window_s"] >= 0.3


def test_unguarded_slice_says_so(monkeypatch):
    monkeypatch.setattr(profile, "_record", _fake_record)
    monkeypatch.setattr(profile, "_read", _fake_read)
    got = profile.profile_slice(0.2, object())
    assert not got["guarded"] and got["cut_by_capture"] == 0


def test_early_cut_is_traced_once_more_and_a_waiting_capture_goes_first(monkeypatch):
    # A capture is waiting when the slice begins: it goes first, and the
    # slice starts after it. A second capture cuts the slice within min_s:
    # that piece is dropped and the rest of the length is traced once more.
    monkeypatch.setattr(profile, "_record", _fake_record)
    monkeypatch.setattr(profile, "_read", _fake_read)
    owner = _Owner()
    real = owner._capture_lock
    order = []

    def capture(delay, name):
        time.sleep(delay)
        with owner._capture_lock:
            order.append((name, time.monotonic()))
            time.sleep(0.05)

    real.acquire()  # a capture in progress when the slice is asked for
    first = threading.Thread(target=capture, args=(0.0, "waiting"))
    cut = threading.Thread(target=capture, args=(0.3, "early"))
    t_start = time.monotonic()

    def release_soon():
        time.sleep(0.1)
        real.release()

    threading.Thread(target=release_soon).start()
    first.start()
    cut.start()
    got = profile.profile_slice(1.0, owner)
    first.join()
    cut.join()
    assert [n for n, _ in order] == ["waiting", "early"]
    assert got["cut_by_capture"] == 1 and got["t0"] > order[-1][1]
    assert got["t1"] - t_start < 1.3 and got["window_s"] > 0.4
