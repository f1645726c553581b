"""Tests for the native host-runtime library (native/obcore.cpp via
ohm_tsd_slam.native).  The same assertions run against the C++
backend when the toolchain built it and the pure-Python fallback
otherwise; `test_native_backend_active` pins that the C++ path is the
one under test in this environment.
"""

import os
import threading
import time

import numpy as np

from ohm_tsd_slam import native


def test_native_backend_active():
    # this image ships g++; the C++ backend must be in use
    assert native.NATIVE


class TestChannel:
    def test_mailbox_latest_wins(self):
        ch = native.Channel(native.MAILBOX)
        ch.push(b"old")
        ch.push(b"new")
        assert ch.pending() == 1
        assert ch.pop_wait(10) == b"new"
        assert ch.dropped() == 1
        assert ch.pop_wait(10) is None

    def test_stack_newest_first(self):
        # ThreadMapping drains back()/pop_back (ThreadMapping.cpp:51-52)
        ch = native.Channel(native.STACK, capacity=8)
        for p in (b"a", b"b", b"c"):
            ch.push(p)
        assert ch.pop_wait(10) == b"c"
        assert ch.pop_wait(10) == b"b"
        assert ch.pop_wait(10) == b"a"

    def test_stack_bounded_drops_oldest(self):
        ch = native.Channel(native.STACK, capacity=2)
        ch.push(b"1")
        ch.push(b"2")
        ch.push(b"3")
        assert ch.pending() == 2
        assert ch.dropped() == 1
        assert ch.pop_wait(10) == b"3"
        assert ch.pop_wait(10) == b"2"

    def test_blocking_producer_consumer(self):
        ch = native.Channel(native.MAILBOX)
        got = []

        def consumer():
            got.append(ch.pop_wait(2000))

        t = threading.Thread(target=consumer)
        t.start()
        time.sleep(0.05)
        ch.push(b"payload")
        t.join(timeout=5)
        assert got == [b"payload"]

    def test_large_payload(self):
        ch = native.Channel(native.STACK)
        big = os.urandom(1 << 20)
        ch.push(big)
        assert ch.pop_wait(10, max_bytes=1 << 22) == big

    def test_close_unblocks(self):
        ch = native.Channel(native.MAILBOX)
        ch.close()
        assert ch.pop_wait(10) is None
        assert not ch.push(b"x")


class TestTimer:
    def test_elapsed_monotonic(self):
        t = native.Timer()
        time.sleep(0.02)
        e1 = t.elapsed()
        assert e1 >= 0.015
        t.reset()
        assert t.elapsed() < e1


class TestLoggerAndImages:
    def test_logger_file_sink(self, tmp_path):
        p = str(tmp_path / "log.txt")
        native.logger_configure(screen_level=-1, file_level=native.LOG_DEBUG,
                                path=p)
        native.log(native.LOG_ERROR, "test", "boom")
        native.log(native.LOG_DEBUG, "test", "detail")
        native.logger_configure(screen_level=native.LOG_WARN)  # detach file
        with open(p) as f:
            content = f.read()
        assert "[ERROR] test: boom" in content
        assert "[DEBUG] test: detail" in content

    def test_ppm_roundtrip(self, tmp_path):
        rgb = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
        p = str(tmp_path / "img.ppm")
        assert native.serialize_ppm(p, np.ascontiguousarray(rgb), 3, 2)
        with open(p, "rb") as f:
            data = f.read()
        assert data.startswith(b"P6\n3 2\n255\n")
        assert data[len(b"P6\n3 2\n255\n"):] == rgb.tobytes()

    def test_pgm_roundtrip(self, tmp_path):
        gray = np.arange(12, dtype=np.uint8).reshape(3, 4)
        p = str(tmp_path / "img.pgm")
        assert native.serialize_pgm(p, np.ascontiguousarray(gray), 4, 3)
        with open(p, "rb") as f:
            data = f.read()
        assert data.startswith(b"P5\n4 3\n255\n")
        assert data[len(b"P5\n4 3\n255\n"):] == gray.tobytes()
