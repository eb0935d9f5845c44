"""The port's chaos suite (the counterpart of tools/chaos.sh for
lightgbm_tpu_torch): every port test marked ``chaos``.

    python3 -m lightgbm_tpu_torch.tools.chaos [--device cpu] [pytest args]

runs ``pytest tests/test_torch_*.py -m chaos`` from the repository root
and exits with pytest's code; arguments it does not know pass through
to pytest (``-k sigkill``, ``-x``, a file list). The matrix:

- crash at round N and resume, bit for bit, in process and for a
  SIGKILL'd ``task=train`` (test_torch_resilience.py); the anomaly
  rollback; the serving host fallback and the serve_request /
  fleet_page faults;
- the online loop's poison / reject / promote sequence and its fault
  matrix in process (test_torch_online.py), and a SIGKILL'd
  ``task=loop`` process at each loop_* site that restarts serving the
  last promotion, replays the spool and promotes v1
  (test_torch_ops_chaos.py);
- the serving gateway: kill -9 of a backend process under load with 0
  client failures and the breaker's open -> half_open -> closed, the
  SIGTERM drain of a backend process and of the gateway with work in
  flight, a hedge overtaking a stalled attempt
  (test_torch_ops_chaos.py);
- the MicroBatcher's overflow and deadline (test_torch_serving_dispatch.py)
  and the operations scripts' whole runs (test_torch_ops_scripts.py).

The tests ask for the CPU themselves (``device_type=cpu``), as every
port test does, and hold the port against the JAX package, which must
be importable; a case marked ``cuda`` runs where a card is present.
Like every entry point of the port the runner refuses to start without
the card unless ``--device cpu`` is given. The fast cases also run in
tier-1; this runs the slow process-spawning ones too.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

from . import _procs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        epilog="other arguments pass through to pytest")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, rest = ap.parse_known_args(argv)
    _procs.require_device(args.device)
    # a test path among the arguments replaces the default file list
    named = any(not a.startswith("-") and (
        _procs.REPO / a.split("::")[0]).exists() for a in rest)
    files = [] if named else sorted(
        str(p.relative_to(_procs.REPO))
        for p in (_procs.REPO / "tests").glob("test_torch_*.py"))
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m", "chaos",
           "-p", "no:cacheprovider", *rest]
    print(" ".join(cmd), flush=True)
    return subprocess.call(cmd, cwd=str(_procs.REPO))


if __name__ == "__main__":
    raise SystemExit(main())
