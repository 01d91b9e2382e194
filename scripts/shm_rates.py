#!/usr/bin/env python3
"""The host rates the weight wire rides on, measured on this machine.

    python3 scripts/shm_rates.py [--gib N]

Run from the root of a checkout on a machine with a card. For a region of
``--gib`` GiB (default 2): a first write into a fresh POSIX shared-memory
segment, a rewrite, a first write into fresh anonymous memory and into a
mapped file under the temp dir; then a second process's copy to the card
(pageable H2D) of a segment the first wrote, mapped plainly and mapped
with ``MAP_POPULATE`` (how ``runtime/transport/ring.py`` maps its rings),
first and second time; and loopback TCP from one process to another. One
line a rate, in GB/s; the first line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import mmap
import multiprocessing
import os
import socket
import subprocess
import tempfile
import time
from multiprocessing import shared_memory


def _rate(label: str, nbytes: int, fn) -> None:
    t0 = time.perf_counter()
    fn()
    dt = time.perf_counter() - t0
    print(f"{label}: {dt:.2f} s ({nbytes / dt / 1e9:.2f} GB/s)", flush=True)


def _reader(name: str, nbytes: int, populate: bool, queue) -> None:
    """A second process: map the segment, copy it to the card twice."""
    import warnings
    import numpy as np
    import torch
    warnings.simplefilter("ignore", UserWarning)   # a read-only source
    if populate:
        fd = os.open(f"/dev/shm/{name}", os.O_RDONLY)
        try:
            owner = mmap.mmap(fd, nbytes, prot=mmap.PROT_READ,
                              flags=mmap.MAP_SHARED | mmap.MAP_POPULATE)
        finally:
            os.close(fd)
        buf = memoryview(owner)
    else:
        owner = shared_memory.SharedMemory(name=name)
        buf = owner.buf
    torch.cuda.init()
    times = []
    for _ in range(2):
        arr = np.frombuffer(buf, np.uint8, count=nbytes)
        t0 = time.perf_counter()
        torch.from_numpy(arr).to("cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del arr
    if populate:
        buf.release()
    del buf
    owner.close()
    queue.put(times)


def _sink(nbytes: int, queue) -> None:
    """A second process: receive ``nbytes`` over loopback TCP."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    queue.put(srv.getsockname()[1])
    conn, _ = srv.accept()
    view = memoryview(bytearray(nbytes))
    got = 0
    while got < nbytes:
        got += conn.recv_into(view[got:])
    conn.sendall(b"x")
    conn.close()
    srv.close()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=float, default=2.0)
    n = int(ap.parse_args().gib * (1 << 30))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    src = bytes(n)
    ctx = multiprocessing.get_context("spawn")

    shm = shared_memory.SharedMemory(create=True, size=n)
    try:
        _rate("/dev/shm first write", n, lambda: shm.buf.__setitem__(
            slice(0, n), src))
        _rate("/dev/shm rewrite", n, lambda: shm.buf.__setitem__(
            slice(0, n), src))
        for populate in (False, True):
            queue = ctx.Queue()
            proc = ctx.Process(target=_reader,
                               args=(shm.name, n, populate, queue))
            proc.start()
            first, second = queue.get()
            proc.join()
            how = "MAP_POPULATE" if populate else "plain map"
            print(f"another process, {how}: H2D from the segment first "
                  f"{first:.2f} s ({n / first / 1e9:.2f} GB/s), second "
                  f"{second:.2f} s ({n / second / 1e9:.2f} GB/s)",
                  flush=True)
    finally:
        shm.close()
        shm.unlink()

    _rate("anonymous memory first write", n, lambda: bytearray(src))
    with tempfile.TemporaryDirectory() as d:
        def file_write():
            with open(os.path.join(d, "f"), "w+b") as f:
                f.truncate(n)
                with mmap.mmap(f.fileno(), n) as mm:
                    mm[:] = src
        _rate("temp-dir mapped file first write", n, file_write)

    queue = ctx.Queue()
    proc = ctx.Process(target=_sink, args=(n, queue))
    proc.start()
    conn = socket.create_connection(("127.0.0.1", queue.get()))

    def send():
        conn.sendall(src)
        conn.recv(1)
    _rate("loopback TCP to another process", n, send)
    conn.close()
    proc.join()


if __name__ == "__main__":
    main()
