"""Multi-host execution — the MPI master/worker analog (jax.distributed).

The reference scales across nodes with a pull-based MPI scatter of read
batches, per-rank output directories, one Bcast and a final Barrier
(/root/reference/src/mpi/MPIChannel.cpp:138-193, mpi_main.cpp:220-318).
The JAX equivalent:

  - `jax.distributed.initialize` forms the process group (coordinator
    address from env or flags) — replacing MPI_Init;
  - input sharding is strided over batch index (each host reads the
    FASTQ and keeps every num_processes-th chunk) — replacing the pull
    scatter; read ids stay globally consistent so hashing/tie-breaks
    match a single-host run;
  - each host runs the full align pipeline and writes its own output
    (the reference's per-rank `<host>-<pid>` dirs);
  - cross-host reductions (stats, duplicate-signature union, the
    partition check) and the final barrier ride `multihost_utils`
    device collectives between processes — replacing the
    mutex/serialized-MPI paths; ranks pinned to one card each
    (CUDA_VISIBLE_DEVICES) join them like ranks on separate hosts. NB
    the reference performs markdup *per rank* with no cross-rank
    exchange; `merge_markdup_signatures` is an optional strictness
    improvement over it.
"""

from __future__ import annotations

import os

import numpy as np


def resolve_coordinator(coordinator: str | None = None) -> str:
    """One source of truth for the coordinator address: explicit flag ->
    BWA_TPU_COORDINATOR env -> localhost default. Every consumer (jax
    coordination service, work-queue host/port derivation) must use this
    so an env-configured multi-host run cannot have nonzero ranks pulling
    from localhost (round-3 advisor finding, cli.py:340)."""
    if coordinator:
        return coordinator
    return os.environ.get("BWA_TPU_COORDINATOR", "localhost:9911")


def parse_hostport(addr: str, default_port: int = 9911
                   ) -> tuple[str, int]:
    """Split host:port accepting IPv6 literals: '[::1]:9911' -> ('::1',
    9911), '::1' -> ('::1', default), 'host:9911' -> ('host', 9911)."""
    addr = addr.strip()
    if addr.startswith("["):            # [v6]:port or [v6]
        host, _, rest = addr[1:].partition("]")
        if rest.startswith(":"):
            return host, int(rest[1:])
        return host, default_port
    if addr.count(":") > 1:             # bare IPv6 literal, no port
        return addr, default_port
    host, sep, port = addr.rpartition(":")
    if not sep:
        return addr, default_port
    return host, int(port)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """MPI_Init analog. Returns (process_id, num_processes)."""
    import jax
    if num_processes is None:
        num_processes = int(os.environ.get("BWA_TPU_NPROCS", "1"))
    if num_processes <= 1:
        return 0, 1
    if process_id is None:
        process_id = int(os.environ["BWA_TPU_PROC_ID"])
    coordinator = resolve_coordinator(coordinator)
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return process_id, num_processes


def shard_batches(batches, process_id: int, num_processes: int):
    """Strided batch assignment (the scatter analog). Every host consumes
    the same read-id numbering; only its own shard is aligned."""
    for i, batch in enumerate(batches):
        if i % num_processes == process_id:
            yield batch


class WorkQueueServer:
    """Pull-based batch-index service — the MPI master loop analog.

    The reference's master rank hands each worker the NEXT read chunk on
    request, so a slow node simply pulls fewer chunks and nobody
    straggles the job (/root/reference/src/mpi/MPIChannel.cpp:138-193:
    SampleChannel::retrieve's MPI_Send(rank)->MPI_Recv(chunk) loop).
    Here the master hands out batch INDEXES over a one-line TCP protocol
    and every host reads its own input (all hosts see the same FASTQ, so
    shipping read data like MPI_Recv does would waste the wire); each
    index is served to exactly one puller.

    Protocol: client sends ``NEXT <token>\\n``, server replies ``<idx>\\n``
    with a monotonically increasing index. The token is a per-run
    identifier all ranks derive from the coordinator address (or
    BWA_TPU_RUN_TOKEN); a stray connection from another job or a
    restarted rank with a different token is refused instead of silently
    consuming indexes (which would lose those batches — no rank would
    ever align them). The server never says "done" — it does not know
    the input length up front (batches stream in); a client past the end
    of its local iterator simply stops pulling. Exact-partition safety
    net: verify_partition() allgathers per-rank aligned counts at the
    end and raises on read loss.
    """

    def __init__(self, host: str = "", port: int = 0,
                 token: str | None = None):
        import socket
        import threading
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
        except OSError:
            if not host:
                raise
            # coordinator address may be a DNS name / VIP not assignable
            # on this host's interfaces (NAT, load balancer): serve on
            # all interfaces instead — clients still connect via the
            # resolved name (advisor r4)
            self._sock.bind(("", port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self.token = run_token() if token is None else token
        self._next = 0
        self._lock = threading.Lock()
        self._closed = False
        self._threads = []
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        import threading
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn):
        want = b"NEXT " + self.token.encode()
        try:
            f = conn.makefile("rwb")
            while True:
                line = f.readline()
                if not line or line.strip() != want:
                    if line:
                        f.write(b"ERR bad token\n")
                        f.flush()
                    return
                with self._lock:
                    idx = self._next
                    self._next += 1
                f.write(b"%d\n" % idx)
                f.flush()
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class WorkQueueClient:
    """Puller side; retries the connect while the master starts up.

    The connect window (BWA_TPU_WQ_TIMEOUT, default 60 s) must cover
    rank-0 startup skew — on big genomes rank 0 spends minutes in index
    load before serving, so pass a larger timeout (the CLI ties it to
    the same env). Known failure mode (documented, unhandled): an index
    pulled by a rank that then crashes is never requeued; surviving
    ranks finish their shards and block at the final barrier until the
    job scheduler kills them — same semantics as the reference's MPI
    (a dead rank hangs the job, mpi_main.cpp)."""

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 token: str | None = None):
        import socket
        import time as _time
        if timeout is None:
            timeout = float(os.environ.get("BWA_TPU_WQ_TIMEOUT", "60"))
        self.token = run_token() if token is None else token
        deadline = _time.time() + timeout
        err = None
        while _time.time() < deadline:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout)
                break
            except OSError as e:
                err = e
                _time.sleep(0.2)
        else:
            raise ConnectionError(
                f"work queue at {host}:{port} unreachable: {err}")
        self._f = self._sock.makefile("rwb")

    def next_index(self) -> int:
        self._f.write(b"NEXT %s\n" % self.token.encode())
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("work queue closed mid-run")
        if line.startswith(b"ERR"):
            raise ConnectionError(
                f"work queue refused request: {line.decode().strip()}")
        return int(line)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def run_token(coordinator: str | None = None) -> str:
    """Per-run work-queue token every rank derives identically (no
    communication needed): BWA_TPU_RUN_TOKEN env, else a digest of the
    resolved coordinator address + process count. Callers that know the
    --coordinator flag must pass it through (advisor r4): deriving from
    the env-only default would mint one shared token for every
    flag-configured job, defeating the stray-connection rejection."""
    tok = os.environ.get("BWA_TPU_RUN_TOKEN")
    if tok:
        return tok
    import hashlib
    basis = (resolve_coordinator(coordinator) + "/"
             + os.environ.get("BWA_TPU_NPROCS", "1"))
    return hashlib.sha1(basis.encode()).hexdigest()[:12]


def verify_partition(n_local_batches: int, n_aligned: int) -> None:
    """Exact-partition check at the end of a pull-mode run: every batch
    index below the (host-identical) input length must have been aligned
    by exactly one rank. The protocol serves each index once, so the only
    loss mode is an index consumed by a connection that never aligned it
    (crashed rank, stray client); that shows up as sum(aligned) <
    n_batches. Raises RuntimeError on loss — silent read loss is the one
    unacceptable failure (round-3 advisor finding)."""
    import jax
    if jax.process_count() == 1:
        return
    counts = allgather_i64(np.asarray(
        [[n_local_batches, n_aligned]], dtype=np.int64))
    n_batches = int(counts[0, 0])
    if not np.all(counts[:, 0] == n_batches):
        raise RuntimeError(
            f"ranks disagree on input length: {counts[:, 0].tolist()}")
    total = int(counts[:, 1].sum())
    if total != n_batches:
        raise RuntimeError(
            f"work-queue partition incomplete: {total} of {n_batches} "
            f"batches aligned (per-rank {counts[:, 1].tolist()}) — "
            "some indexes were consumed but never aligned")


def pull_batches(batches, client: "WorkQueueClient", tally: dict = None):
    """Dynamic batch assignment: align exactly the batch indexes pulled
    from the master's queue. Read-id numbering stays global (every host
    walks the whole local iterator), like shard_batches, so hash_64
    tie-breaks match a single-host run. `tally` (optional dict) receives
    n_batches/n_aligned for verify_partition."""
    n_seen = 0
    n_aligned = 0
    try:
        want = client.next_index()
        for i, batch in enumerate(batches):
            n_seen = i + 1
            if i == want:
                yield batch
                n_aligned += 1
                want = client.next_index()
    finally:
        client.close()
        if tally is not None:
            tally["n_batches"] = n_seen
            tally["n_aligned"] = n_aligned


def workqueue_addr(coordinator: str | None) -> tuple[str, int]:
    """(host, port) of the work-queue service, derived from the RESOLVED
    jax.distributed coordinator (flag -> env -> default; the
    coordinator's own port is taken by the coordination service)."""
    host, port = parse_hostport(resolve_coordinator(coordinator))
    return host, port + 137


def workqueue_port(coordinator: str | None) -> int:
    return workqueue_addr(coordinator)[1]


def allgather_i64(rows: np.ndarray) -> np.ndarray:
    """All-gather variable-length int64[N, K] rows across hosts (pads to
    the global max and strips). Single-process: identity."""
    import jax
    if jax.process_count() == 1:
        return rows
    from jax.experimental import multihost_utils as mhu
    n = np.asarray([rows.shape[0]], dtype=np.int64)
    counts = np.asarray(mhu.process_allgather(n)).reshape(-1)
    cap = int(counts.max())
    k = rows.shape[1] if rows.size else 3
    pad = np.zeros((cap, k), dtype=np.int64)
    pad[:rows.shape[0]] = rows
    gathered = np.asarray(mhu.process_allgather(pad))
    out = [gathered[p, :int(c)] for p, c in enumerate(counts)]
    return np.concatenate(out, axis=0) if out else rows


def merge_markdup_signatures(state) -> None:
    """Union all hosts' duplicate signatures into this host's state
    (optional strictness pass; the reference keeps markdup per rank)."""
    rows = np.asarray(state.signature_items(), dtype=np.int64)
    if rows.size == 0:
        rows = np.zeros((0, 3), dtype=np.int64)
    merged = allgather_i64(rows)
    state.merge(merged.tolist())


def reduce_stats(stats: dict) -> dict:
    """Sum numeric pipeline counters across hosts (final-report analog)."""
    import jax
    if jax.process_count() == 1:
        return dict(stats)
    keys = sorted(stats)
    vals = np.asarray([[float(stats[k]) for k in keys]])
    from jax.experimental import multihost_utils as mhu
    allv = np.asarray(mhu.process_allgather(vals)).reshape(
        jax.process_count(), len(keys))
    return {k: allv[:, i].sum() for i, k in enumerate(keys)}


def barrier() -> None:
    """Final Barrier (mpi_main.cpp:319-325): waits, unbounded, for every
    process."""
    import jax
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils as mhu
        mhu.sync_global_devices("bwa_flow_tpu_barrier")
