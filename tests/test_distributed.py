"""Multi-host layer: 2-process jax.distributed run on localhost CPU,
covering batch sharding, signature all-gather, stat reduction, barrier."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import oracle as orc

from bwa_flow_tpu.parallel.distributed import shard_batches

WORKER = textwrap.dedent("""
    import os, sys, json
    import numpy as np
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    from bwa_flow_tpu.parallel import distributed as dist

    pid = int(sys.argv[1]); n = int(sys.argv[2]); port = sys.argv[3]
    dist.init_distributed(f"localhost:{port}", n, pid)
    assert jax.process_count() == n

    # signature union
    from bwa_flow_tpu.dedup.markdup import MarkDupState
    class A:
        def __init__(s, name, l): s.name, s.len = name, l
    st = MarkDupState([A("c1", 1000)])
    st.sigs.add((pid, 0, 1234 + pid))   # distinct per host
    dist.merge_markdup_signatures(st)
    assert len(st.sigs) == n, st.sigs

    stats = dist.reduce_stats({"reads": 10 * (pid + 1), "waves": 1})
    dist.barrier()
    print(json.dumps({"pid": pid, "sigs": len(st.sigs),
                      "reads": stats["reads"]}))
""")


def test_shard_batches():
    batches = [[i] for i in range(10)]
    got0 = list(shard_batches(iter(batches), 0, 3))
    got1 = list(shard_batches(iter(batches), 1, 3))
    got2 = list(shard_batches(iter(batches), 2, 3))
    assert got0 == [[0], [3], [6], [9]]
    assert got1 == [[1], [4], [7]]
    assert got2 == [[2], [5], [8]]


def test_two_process_collectives(tmp_path):
    port = "9917"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = orc.cli_env()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    import json
    rows = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert all(r["sigs"] == 2 for r in rows)
    assert all(r["reads"] == 30.0 for r in rows)  # 10 + 20


def test_pull_workqueue_partition_and_balance():
    """Pull-based distribution (round-2 verdict task 7): every batch is
    assigned to exactly one puller, and a straggler self-load-balances —
    the fast puller takes more batches instead of the job waiting on the
    slow one (the reference's MPI master loop property,
    /root/reference/src/mpi/MPIChannel.cpp:138-193)."""
    import threading
    import time

    from bwa_flow_tpu.parallel.distributed import (
        WorkQueueClient, WorkQueueServer, pull_batches)

    srv = WorkQueueServer(port=0)
    batches = [[i] for i in range(40)]
    got = [[], []]

    def run(rank, delay):
        cl = WorkQueueClient("127.0.0.1", srv.port)
        for b in pull_batches(iter(batches), cl):
            got[rank].append(b[0])
            time.sleep(delay)

    ts = [threading.Thread(target=run, args=(0, 0.0)),
          threading.Thread(target=run, args=(1, 0.02))]  # rank 1 straggles
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    srv.close()
    assert sorted(got[0] + got[1]) == list(range(40))   # exact partition
    assert not (set(got[0]) & set(got[1]))
    # dynamic balance: the fast rank pulled the lion's share
    assert len(got[0]) > len(got[1]) * 2, (len(got[0]), len(got[1]))


def test_pull_workqueue_order_within_rank():
    """Each rank sees its pulled batches in input order (ordered emission
    depends on it)."""
    from bwa_flow_tpu.parallel.distributed import (
        WorkQueueClient, WorkQueueServer, pull_batches)

    srv = WorkQueueServer(port=0)
    cl = WorkQueueClient("127.0.0.1", srv.port)
    out = [b[0] for b in pull_batches(iter([[i] for i in range(7)]), cl)]
    srv.close()
    assert out == list(range(7))


def test_parse_hostport_ipv6():
    from bwa_flow_tpu.parallel.distributed import parse_hostport
    assert parse_hostport("localhost:9911") == ("localhost", 9911)
    assert parse_hostport("host") == ("host", 9911)
    assert parse_hostport("[::1]:9931") == ("::1", 9931)
    assert parse_hostport("::1") == ("::1", 9911)
    assert parse_hostport("[fe80::2]") == ("fe80::2", 9911)
    assert parse_hostport("10.0.0.2:80", 9000) == ("10.0.0.2", 80)


def test_workqueue_rejects_bad_token():
    """A stray connection with the wrong run token must be refused, not
    silently consume batch indexes (round-3 advisor: silent read loss)."""
    from bwa_flow_tpu.parallel.distributed import (
        WorkQueueClient, WorkQueueServer)

    srv = WorkQueueServer(port=0, token="good")
    ok = WorkQueueClient("127.0.0.1", srv.port, token="good")
    assert ok.next_index() == 0
    bad = WorkQueueClient("127.0.0.1", srv.port, token="evil")
    with pytest.raises(ConnectionError):
        bad.next_index()
    # the refused request consumed nothing
    assert ok.next_index() == 1
    ok.close()
    bad.close()
    srv.close()


def test_workqueue_addr_env(monkeypatch):
    """Work-queue host/port must follow BWA_TPU_COORDINATOR when no flag
    is given (round-3 advisor: nonzero ranks connected to localhost)."""
    from bwa_flow_tpu.parallel.distributed import workqueue_addr
    monkeypatch.setenv("BWA_TPU_COORDINATOR", "10.1.2.3:7000")
    assert workqueue_addr(None) == ("10.1.2.3", 7137)
    # explicit flag wins
    assert workqueue_addr("h:8000") == ("h", 8137)
