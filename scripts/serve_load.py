#!/usr/bin/env python3
"""A load generator for the caption server, in a process of its own.

    python3 scripts/serve_load.py URL N < paths

Reads image paths from standard input, one a line, and POSTs each file's
bytes to URL (the server's ``/caption``) from N client threads, the
requests spread over the threads in turn and every thread started at
once.  Prints one JSON object: ``{"seconds": from the first send to the
last reply, "replies": [[status, reply json, seconds], ...]}``, the
replies in the input's order (status -1 and ``{"error": ...}`` where the
request itself failed).  Standard library only: the clients' work stays
out of the server's process and its interpreter lock.
"""
from __future__ import annotations

import http.client
import json
import sys
import threading
import time
import urllib.parse


def post(url: str, data: bytes, timeout: float = 300.0):
    """POST ``data`` on a connection of its own -> [status, reply json,
    seconds].  ``http.client`` and not ``urllib.request``: a thread's first
    ``urlopen`` builds an opener whose HTTPS handler loads the system's CA
    certificates, seconds of one core when hundreds of threads start
    together."""
    u = urllib.parse.urlsplit(url)
    t0 = time.perf_counter()
    try:
        conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
        try:
            conn.request("POST", u.path, body=data)
            r = conn.getresponse()
            code, body = r.status, json.loads(r.read())
        finally:
            conn.close()
    except (OSError, http.client.HTTPException, ValueError) as e:
        code, body = -1, {"error": repr(e)}
    return [code, body, time.perf_counter() - t0]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    url, n = argv[0], int(argv[1])
    paths = [p for p in sys.stdin.read().splitlines() if p]
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    replies = [None] * len(blobs)
    go = threading.Barrier(n + 1)

    def client(k):
        go.wait()
        for i in range(k, len(blobs), n):
            replies[i] = post(url, blobs[i])

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(n)]
    for t in threads:
        t.start()
    go.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    print(json.dumps({"seconds": wall, "replies": replies}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
