"""The open-loop load generator, run as a child process of the serving
driver (numpy and the standard library only)::

    python3 -m port_bench.drivers.loadgen '<json>'

The JSON holds ``port``, ``path``, ``seed``, ``rate``, ``seconds``,
``sizes``, ``weights``, ``image_size``, ``bank``, ``clients`` (threads, each
with one keep-alive connection), ``grace_s`` and ``sample`` (the requests
whose answers are sent back). A dispatcher hands each request of
``traffic.schedule`` to a free client when it is due; a request is timed
from when it was due to when its answer was read, so a late send counts.
The child prints ``START <wall clock>`` when its window opens, then one
JSON line: each request's ``due``, ``sent`` and ``done`` seconds from the
window's start (``done`` null where no answer came), its HTTP status, and
the sampled answers' bytes in base64.
"""

from __future__ import annotations

import base64
import json
import queue
import sys
import threading
import time
from http.client import HTTPConnection

from port_bench import traffic


def main(arg: str) -> None:
    a = json.loads(arg)
    bank = traffic.image_bank(a["seed"], a["bank"], a["image_size"])
    rows = [bank[i].tobytes() for i in range(len(bank))]
    del bank
    sched = traffic.schedule(a["seed"], a["rate"], a["seconds"], a["sizes"],
                             a["weights"], a["bank"])
    due, images = sched["due"], sched["images"]
    n = len(due)
    sent, done, status = [None] * n, [None] * n, [None] * n
    keep = set(a["sample"])
    answers = {}
    work: "queue.Queue" = queue.Queue()
    deadline = [float("inf")]

    def client():
        conn = HTTPConnection("127.0.0.1", a["port"], timeout=a["grace_s"])
        while True:
            i = work.get()
            if i is None:
                return
            body = b"".join(rows[j] for j in images[i])
            sent[i] = time.perf_counter() - t0
            try:
                conn.request("POST", a["path"], body, {
                    "Content-Type": "application/octet-stream"})
                resp = conn.getresponse()
                data = resp.read()
                status[i] = resp.status
                if time.perf_counter() < deadline[0]:
                    done[i] = time.perf_counter() - t0
                if i in keep and resp.status == 200:
                    answers[i] = base64.b64encode(data).decode()
            except Exception as e:  # the request failed; reconnect
                status[i] = f"{type(e).__name__}: {e}"
                conn.close()
                conn = HTTPConnection("127.0.0.1", a["port"],
                                      timeout=a["grace_s"])

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(a["clients"])]
    for t in threads:
        t.start()
    t0 = time.perf_counter() + 0.05
    print(f"START {time.time() + 0.05!r}", flush=True)
    for i in range(n):
        wait = t0 + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        work.put(i)
    deadline[0] = t0 + due[-1] + a["grace_s"]
    for _ in threads:
        work.put(None)
    for t in threads:
        t.join(max(0.0, deadline[0] - time.perf_counter()))
    print(json.dumps({"due": due, "sent": sent, "done": done,
                      "status": status, "images": [len(x) for x in images],
                      "answers": answers}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
