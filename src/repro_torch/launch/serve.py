"""Eigensolver serving launcher: resident matrices, a synthetic query stream,
and the serving stats that show the amortization end to end.

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke              # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

Generates a pool of sparse matrices, makes them resident in an
``EigenScheduler``, fires a threaded synthetic query stream at it and prints
the ``ServerStats`` snapshot (throughput, p50/p99 latency, coalesce rate).
With a persistent store (``--store``, or a temporary directory under
``--smoke``) it then simulates a server restart: a second scheduler warms
every matrix from the store, and the conversion and tuner-probe counters
must not move (the warm-start contract, checked live).

``--kill-resume`` is the crash drill: run the smoke as a child process,
SIGTERM it mid-burst, check that it shuts down within a bound (the
scheduler's close path fails pending futures typed, so no submitter thread
hangs), then restart against the same store and check the warm resume.
SIGTERM is turned into a graceful ``SystemExit`` so the scheduler's context
manager unwinds.

The counterpart of the reference's ``repro/launch/serve.py``; it runs on the
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time


def _build_matrices(args):
    from repro_torch.sparse import generate

    specs = [("web", 6.0), ("road", 3.0), ("web", 9.0)][: args.matrices]
    return [
        generate(kind, args.n, deg, seed=11 + i, values="normalized")
        for i, (kind, deg) in enumerate(specs)
    ]


def _run_stream(sched, keys, args):
    """Threaded synthetic stream: each submitter thread round-robins the
    resident matrices with compatible queries (one group key per matrix),
    so the admission window has something to coalesce."""
    from repro_torch.serving import DeadlineExceededError, QueueFullError

    errors = []
    lock = threading.Lock()

    def submitter(tid: int):
        handles = []
        for i in range(args.queries_per_thread):
            key = keys[(tid + i) % len(keys)]
            k = 2 + (i % 3) * 2  # k in {2, 4, 6}: one sweep, sliced
            try:
                handles.append(sched.submit(key, k=k, num_iters=args.iters, reorth="full"))
            except (QueueFullError, DeadlineExceededError) as exc:
                with lock:
                    errors.append(exc)
        for h in handles:
            try:
                h.result(timeout=120.0)
            except Exception as exc:  # counted and reported by the caller
                with lock:
                    errors.append(exc)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(args.threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, errors


def _install_sigterm_handler() -> None:
    """Turn SIGTERM into ``SystemExit(143)``: the scheduler's context
    manager then runs ``close()`` (in-flight work finishes, queued futures
    fail typed).  Main thread only (the signal API's rule)."""
    if threading.current_thread() is not threading.main_thread():
        return

    def _graceful(signum, frame):
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _graceful)


def _kill_resume(args) -> int:
    """The crash drill (see the module docstring)."""
    own = args.store is None
    store_dir = args.store or tempfile.mkdtemp(prefix="repro-torch-serving-")
    try:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--store", store_dir,
               "--device", args.device]
        child = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        resident = False
        for line in child.stdout:
            print(f"[child] {line}", end="")
            if line.startswith("resident:"):
                resident = True
                break
        if not resident:
            child.kill()
            child.wait()
            print("FAIL: child exited before its matrices became resident")
            return 1
        time.sleep(1.0)  # land the SIGTERM inside the query burst
        child.send_signal(signal.SIGTERM)
        try:
            out, _ = child.communicate(timeout=60.0)
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
            print("FAIL: child hung after SIGTERM: stranded queries in shutdown")
            return 1
        for line in out.splitlines():
            print(f"[child] {line}")
        print(f"kill-resume: child exited rc={child.returncode} within bound after SIGTERM")
        if main(["--smoke", "--store", store_dir, "--device", args.device]) != 0:
            print("FAIL: restart after SIGTERM did not warm-resume")
            return 1
        print("kill-resume: warm resume after SIGTERM verified")
        return 0
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true", help="small sizes, temp store, fast")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--n", type=int, default=4096, help="matrix dimension")
    ap.add_argument("--matrices", type=int, default=2, help="resident matrix pool size")
    ap.add_argument("--threads", type=int, default=4, help="concurrent submitter threads")
    ap.add_argument("--queries-per-thread", type=int, default=8)
    ap.add_argument("--iters", type=int, default=24, help="Lanczos steps per sweep")
    ap.add_argument("--window-ms", type=float, default=20.0, help="admission window")
    ap.add_argument("--max-group", type=int, default=16)
    ap.add_argument("--store", default=None, help="session store dir (persists warm state)")
    ap.add_argument("--kill-resume", action="store_true",
                    help="crash drill: SIGTERM a child smoke run mid-burst, then check "
                    "bounded shutdown + warm resume from the same store")
    args = ap.parse_args(argv)
    _install_sigterm_handler()
    if args.kill_resume:
        return _kill_resume(args)
    if args.smoke:
        args.n = min(args.n, 1024)
        args.matrices = min(args.matrices, 2)
        args.threads = min(args.threads, 3)
        args.queries_per_thread = min(args.queries_per_thread, 6)

    from repro_torch.api import SolverConfig
    from repro_torch.kernels.engine import tuner_probe_count
    from repro_torch.serving import EigenScheduler, SchedulerConfig, SessionStore
    from repro_torch.sparse.formats import conversion_count

    own_store = args.store is None and args.smoke
    store_dir = args.store or (tempfile.mkdtemp(prefix="repro-torch-serving-") if args.smoke
                               else None)
    try:
        store = SessionStore(store_dir) if store_dir else None
        cfg = SchedulerConfig(admission_window_s=args.window_ms * 1e-3, max_group=args.max_group,
                              max_sessions=max(args.matrices, 2))
        solver = SolverConfig(device=args.device)
        matrices = _build_matrices(args)
        with EigenScheduler(cfg, store=store) as sched:
            t0 = time.perf_counter()
            keys = [sched.add_matrix(m, name=f"mat{i}", config=solver)
                    for i, m in enumerate(matrices)]
            prep_s = time.perf_counter() - t0
            print(f"resident: {len(keys)} matrices (n={args.n}) on {args.device} prepared in "
                  f"{prep_s:.2f}s", flush=True)
            wall, errors = _run_stream(sched, keys, args)
            stats = sched.stats()
            qps = stats.completed / wall if wall > 0 else 0.0
            print(stats.summary())
            print(f"throughput: {stats.completed} queries in {wall:.2f}s = {qps:.1f} q/s")
            if errors:
                print(f"stream errors: {len(errors)} ({type(errors[0]).__name__}: {errors[0]})")
        if errors:
            return 1
        if store is not None:
            # Simulated restart: a fresh scheduler warms every matrix from the
            # store without converting or probing anything.
            conv0, probes0 = conversion_count(), tuner_probe_count()
            with EigenScheduler(cfg, store=store) as sched2:
                for i, m in enumerate(matrices):
                    sched2.add_matrix(m, name=f"mat{i}", config=solver)
                s2 = sched2.stats()
                res = sched2.submit("mat0", k=4, num_iters=args.iters,
                                    reorth="full").result(timeout=120.0)
            dconv, dprobes = conversion_count() - conv0, tuner_probe_count() - probes0
            print(f"restart: {s2.warm_starts}/{len(matrices)} sessions warm-started, {dconv} "
                  f"conversions, {dprobes} tuner probes, first solve reused={res.session_reuse}")
            if s2.warm_starts != len(matrices) or dconv or dprobes or not res.session_reuse:
                print("FAIL: warm restart paid conversions or probes")
                return 1
            print("warm-restart contract verified: zero conversions and probes after restart")
        return 0
    finally:
        if own_store:
            shutil.rmtree(store_dir, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
