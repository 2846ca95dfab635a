"""Replay of pytest-xdist 3.8's ``LoadScheduling`` for the suite's
``-n 6 --dist load`` command: which worker runs which tests, from a
collection and the durations of a run's junit XML.

    python -m pytest tests/ -q -m 'not slow' --collect-only \
        -p no:randomly > collect.txt
    python scripts/xdist_replay.py collect.txt run.xml \
        "{'tests/test_new.py::test_a': 3.0}"

The first chunk is N // 24 tests a worker, then each completion refills
the worker by the remaining count and the test's duration
(``check_schedule``); a worker runs its queue's head only while it holds
two or more. For each worker it prints how many tests of
test_fused_sharded.py, test_scalar.py and test_sharding.py it runs (the
JAX files whose executables can crash a worker that loads them together)
and marks a schedule BAD where one worker
runs 20 or more of the first with any of the others: once without
jitter, and with each duration jittered by up to 20%."""
import heapq
import random
import sys
import xml.etree.ElementTree as ET

def load_collection(path):
    ids = []
    for l in open(path):
        l = l.strip()
        if "::" in l and not l.startswith(("=", "<")):
            ids.append(l)
    return ids

def load_durations(xml):
    d = {}
    for tc in ET.parse(xml).getroot().iter("testcase"):
        cls = tc.get("classname", ""); name = tc.get("name")
        f = cls.replace(".", "/") + ".py"
        d[f"{f}::{name}"] = float(tc.get("time", 0))
    return d

def replay(ids, dur, nodes=6, jitter=0.0, seed=0):
    rnd = random.Random(seed)
    N = len(ids)
    pending = list(range(N))
    node_pending = {n: [] for n in range(nodes)}
    ran = {n: [] for n in range(nodes)}
    chunk = max(min(N // nodes // 4, N), 2)
    for n in range(nodes):
        node_pending[n].extend(pending[:chunk]); del pending[:chunk]
    t = 0.0
    busy_until = {}
    events = []
    def start(n, now):
        # a worker runs its head while it holds >= 2 items (or none pending globally)
        q = node_pending[n]
        if q and (len(q) >= 2 or not pending) and n not in busy_until:
            i = q[0]
            d = dur.get(ids[i], 0.5) * (1 + rnd.uniform(-jitter, jitter))
            busy_until[n] = now + d
            heapq.heappush(events, (now + d, n, i, d))
    for n in range(nodes): start(n, 0.0)
    while events:
        now, n, i, d = heapq.heappop(events)
        del busy_until[n]
        node_pending[n].remove(i); ran[n].append(i)
        if pending:
            nn = nodes
            mn = max(2, len(pending) // nn // 4); mx = max(2, len(pending) // nn // 2)
            q = node_pending[n]
            if len(q) < mn and not (d >= 0.1 and len(q) >= 2):
                k = min(mx - len(q), max(2 - len(q), N))
                q.extend(pending[:k]); del pending[:k]
        for m in range(nodes): start(m, now)
    return ran

def summarize(ids, ran):
    out = []
    for n, lst in ran.items():
        files = [ids[i].split("::")[0] for i in lst]
        fs = sum(f.endswith("test_fused_sharded.py") for f in files)
        sc = sum(f.endswith("test_scalar.py") for f in files)
        sh = sum(f.endswith("test_sharding.py") for f in files)
        out.append((n, fs, sc, sh))
    return out

if __name__ == "__main__":
    ids = load_collection(sys.argv[1]); dur = load_durations(sys.argv[2])
    extra = eval(sys.argv[3]) if len(sys.argv) > 3 else {}
    dur.update(extra)
    print("N", len(ids), "missing durations", sum(i not in dur for i in ids))
    for jit, seed in [(0.0, 0)] + [(0.2, s) for s in range(1, 6)]:
        s = summarize(ids, replay(ids, dur, jitter=jit, seed=seed))
        bad = [x for x in s if x[1] >= 20 and (x[2] or x[3])]
        print("jitter", jit, "seed", seed, s, "BAD" if bad else "ok")
