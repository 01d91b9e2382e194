"""Connect-mode rollout worker CLI (the multi-host lifecycle), as the
reference ``repro/launch/worker.py``.

Dial a running :class:`~repro_torch.runtime.transport.server.TransportServer`
(any port ``AcceRLSystem`` with ``rt.transport.connect_rollout_workers >
0``),
authenticate with the shared token, receive a worker slot's spec over the
``worker.hello`` handshake, and run the standard worker body
(``worker_main``) against that server — the SAME code a parent-spawned
worker runs, just started from another terminal (or another host):

    PYTHONPATH=src python -m repro_torch.launch.worker \
        --address 127.0.0.1:5555 --token sekrit

The hello is retried with a short period until a slot opens (a freshly
killed worker's slot re-opens only after its liveness window lapses), so
"redial to rejoin" is literally re-running this command. A stopped or
superseded incarnation exits cleanly when its report reply says ``stop``.
The worker serves on the device its spec names.
"""
from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import time
from typing import Optional


def run(address: str, *, token: str = "", name: Optional[str] = None,
        hello_timeout_s: float = 60.0, retry_s: float = 0.5) -> int:
    """Handshake until assigned (or ``hello_timeout_s``), then run the
    worker body. Returns a process exit code."""
    from repro_torch.runtime.transport.channel import (TransportError,
                                                       WireClient,
                                                       parse_address)
    from repro_torch.runtime.transport.remote import (spec_from_wire,
                                                      worker_main)

    addr = parse_address(address)
    deadline = time.monotonic() + hello_timeout_s
    while True:
        client = None
        try:
            client = WireClient(
                addr, connect_timeout=max(deadline - time.monotonic(), 0.1))
            header = {"m": "worker.hello", "token": token}
            if name:
                header["worker"] = name
            resp, _ = client.request(header)
            client.close()
            break
        except TransportError as e:        # includes ChannelClosed
            if client is not None:
                client.close()
            if time.monotonic() >= deadline:
                print(f"worker: no slot within {hello_timeout_s:.0f}s — "
                      f"giving up ({e})", file=sys.stderr)
                return 2
            # ±25% jitter: a fleet redialing a replaced server spreads
            # its hellos instead of hammering the listener in lockstep
            time.sleep(retry_s * (0.75 + 0.5 * random.random()))
    # the spec's address is as the SERVER sees itself; dial-side knows the
    # reachable one (NAT/0.0.0.0 binds), so the dialed address wins
    spec = dataclasses.replace(spec_from_wire(resp["spec"]), address=addr)
    print(f"worker {spec.name!r}: attached as incarnation "
          f"{spec.incarnation} -> {addr[0]}:{addr[1]} "
          f"({spec.num_envs} env(s), suite {spec.suite!r}, device "
          f"{spec.device})")
    return worker_main(spec)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="connect-mode AcceRL rollout worker")
    ap.add_argument("--address", required=True, metavar="HOST:PORT",
                    help="TransportServer to dial")
    ap.add_argument("--token", default="",
                    help="shared secret for the worker.hello handshake")
    ap.add_argument("--name", default=None,
                    help="specific slot to claim (default: first open)")
    ap.add_argument("--hello-timeout", type=float, default=60.0,
                    help="seconds to keep redialing for an open slot")
    args = ap.parse_args()
    sys.exit(run(args.address, token=args.token, name=args.name,
                 hello_timeout_s=args.hello_timeout))


if __name__ == "__main__":
    main()
