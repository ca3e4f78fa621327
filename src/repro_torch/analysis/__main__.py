"""CLI gate: ``python -m repro_torch.analysis check``.

Evaluates every contract in ``contracts.toml`` at its probe shape and runs
the source-level RNG sweep; exits non-zero on any violation.

  check                     evaluate all contracts + the RNG sweep
  check --only NAME         one contract (sweep skipped)
  check --update            re-measure and ratchet `measured_peak_bytes` DOWN
  check --json PATH         write the full JSON report
  check --device cuda|cpu   where the probes run (default cuda)
"""
from __future__ import annotations

import argparse
import json
import sys


def _cmd_check(args) -> int:
    from repro_torch.analysis import contracts as C

    results, sweep, _ = C.run_check(only=args.only, update=args.update, device=args.device)
    failed = 0
    for res in results:
        mark = {"pass": "ok  ", "skipped": "skip", "fail": "FAIL"}[res.status]
        r = res.report
        if res.measured_peak_bytes is not None:
            extra = (f"  peak={res.measured_peak_bytes}B dispatches={r['kernel_dispatches']} "
                     f"syncs={r['host_syncs']} ops={r['eqn_count']}")
            if "kernel_launches" in r:
                extra += (f" launches={r['kernel_launches']} "
                          f"mem_rise={r['memory_rise_bytes']}B")
        else:
            extra = f"  ({r.get('reason', '')})"
        print(f"[{mark}] {res.name}{extra}")
        for v in res.violations:
            print(f"       - {v}")
        failed += res.status == "fail"
    if args.only is None:
        if sweep:
            print(f"[FAIL] rng sweep: {len(sweep)} unregistered site(s)")
            for s in sweep:
                print(f"       - {s.path}:{s.lineno}: {s.source}")
                print("         register a stream in repro_torch.analysis.streams "
                      "(tag constant or `# rng-stream:` marker)")
            failed += 1
        else:
            print("[ok  ] rng sweep: every site registered")
    if args.json:
        payload = {
            "results": [r.to_dict() for r in results],
            "rng_sweep_violations": [{"path": s.path, "lineno": s.lineno,
                                      "source": s.source} for s in sweep],
            "failed": failed,
        }
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2, default=str)
        print(f"report written to {args.json}")
    if failed:
        print(f"{failed} violation group(s); see above. (`--update` only ratchets "
              "budgets DOWN — raising one is a reviewed edit to contracts.toml.)")
    return 1 if failed else 0


def main(argv=None) -> int:
    """Entry point for ``python -m repro_torch.analysis``."""
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = parser.add_subparsers(dest="cmd", required=True)
    chk = sub.add_parser("check", help="evaluate all trace contracts")
    chk.add_argument("--only", default=None, metavar="NAME",
                     help="evaluate a single contract")
    chk.add_argument("--update", action="store_true",
                     help="ratchet measured peaks downward into the manifest")
    chk.add_argument("--json", default=None, metavar="PATH",
                     help="write the JSON report")
    chk.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                     help="where the probes run (default: cuda)")
    args = parser.parse_args(argv)
    return _cmd_check(args)


if __name__ == "__main__":
    sys.exit(main())
