#!/usr/bin/env bash
# The port's tier-1 verification (scripts/tier1.sh is the JAX package's).
# Run from the repo root:  ./scripts/torch/tier1.sh
#   On the CPU (--device cpu) the tests are the port's parity tests,
#   tests/test_torch_*.py, which hold it against the JAX package; on the
#   card (--device cuda, the default) the card's tests, -m cuda in
#   tests/test_torch_cuda.py, without tests/conftest.py (it imports JAX,
#   which the card's host does not have).  Test paths or pytest options
#   given on the command line are passed on (a path replaces the default
#   files).
# With the layout-contract analyzer:  ./scripts/torch/tier1.sh --analyze
#   (scripts/torch/analyze.py: the shape-ladder linter, the KV-write
#   aliasing pass, the recompile-hazard detector, the AST lint, and a
#   sanitized drain over every engine configuration; any finding fails)
# With the attribution-report smoke:  ./scripts/torch/tier1.sh --report
#   (scripts/torch/report_smoke.py: attribution completeness, the
#   Prometheus lint, the single-file HTML report, the warmup-only cost
#   model with no new step signature after warmup; any violation fails)
# With the seeded fault-plan smoke:  ./scripts/torch/tier1.sh --chaos
#   (scripts/torch/chaos_smoke.py: survivors identical to the clean drain
#   under each seeded FaultPlan, the allocator balanced, no new step
#   signature after warmup; any violation fails)
# The serving benchmark's smoke (scripts/tier1.sh --bench-smoke) has no
# counterpart here yet: the port's benchmark is still to come.
set -euo pipefail
cd "$(dirname "$0")/../.."

ANALYZE=0
CHAOS=0
REPORT=0
DEVICE=cuda
ARGS=()
PATHS=0
while [[ $# -gt 0 ]]; do
  case "$1" in
    --analyze) ANALYZE=1 ;;
    --chaos) CHAOS=1 ;;
    --report) REPORT=1 ;;
    --device) DEVICE="$2"; shift ;;
    --device=*) DEVICE="${1#--device=}" ;;
    *) [[ "$1" == tests/* ]] && PATHS=1; ARGS+=("$1") ;;
  esac
  shift
done

export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
if [[ "$DEVICE" == cpu ]]; then
  [[ "$PATHS" == 1 ]] || ARGS+=(tests/test_torch_*.py)
  python -m pytest -x -q --durations=15 "${ARGS[@]}"
else
  [[ "$PATHS" == 1 ]] || ARGS+=(tests/test_torch_cuda.py)
  python -m pytest -x -q --durations=15 -m cuda --noconftest "${ARGS[@]}"
fi

if [[ "$ANALYZE" == 1 ]]; then
  python scripts/torch/analyze.py --device "$DEVICE"
fi

if [[ "$CHAOS" == 1 ]]; then
  python scripts/torch/chaos_smoke.py --device "$DEVICE"
fi

if [[ "$REPORT" == 1 ]]; then
  python scripts/torch/report_smoke.py --device "$DEVICE"
fi
