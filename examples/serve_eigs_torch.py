"""Eigensolver-as-a-service on the PyTorch port: continuous batching end to
end, the counterpart of ``examples/serve_eigs.py``.

Makes one web graph resident in an ``EigenScheduler``, fires concurrent
Top-K queries at it from several threads, and shows the serving contract:
every request gets its own ``EigenResult`` future, compatible requests share
Lanczos sweeps (the coalesce rate), and the queue/solve latency split rides
in each result's timings.  Runs on the card unless ``--device cpu``:

    PYTHONPATH=src python examples/serve_eigs_torch.py [--device cpu]
"""

import argparse
import tempfile
import threading

from repro_torch.api import SolverConfig
from repro_torch.serving import EigenScheduler, SchedulerConfig, SessionStore
from repro_torch.sparse import generate


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    csr = generate("web", 2048, 8.0, seed=7, values="normalized")
    cfg = SchedulerConfig(admission_window_s=0.05, max_group=16)

    with tempfile.TemporaryDirectory() as root, \
            EigenScheduler(cfg, store=SessionStore(root)) as sched:
        key = sched.add_matrix(csr, name="web-2048", config=SolverConfig(device=args.device))
        results = {}

        def client(cid: int):
            # Same num_iters/reorth/policy: one group key, so these queries
            # ride one shared sweep and slice their own Ritz pairs from it.
            h = sched.submit(key, k=2 + 2 * (cid % 3), num_iters=32, reorth="full",
                             deadline_s=30.0)
            results[cid] = h.result(timeout=60.0)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        for cid in sorted(results):
            r = results[cid]
            print(f"client {cid}: k={r.k} |lambda_1|={float(abs(r.eigenvalues[0])):.6f} "
                  f"queue={r.timings['queue_s'] * 1e3:.1f}ms "
                  f"solve={r.timings['solve_s'] * 1e3:.1f}ms "
                  f"amortized_over={r.timings.get('amortized_over', 1)}")
        print()
        print(sched.stats().summary())


if __name__ == "__main__":
    main()
