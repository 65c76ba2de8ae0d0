#!/usr/bin/env bash
# Suite runner with per-file segfault retries.
#
# XLA:CPU has intermittently SIGSEGVed inside compilation
# (backend_compile_and_load / executable.serialize) — roughly once per
# ~40 min of compile activity, independent of the persistent cache
# (which is disabled in conftest for the same reason).  The crash is in
# the compiler, not the tests: a retry of the same file passes.  This
# wrapper runs pytest one file at a time and retries a file when the
# exit code signals a signal-death (>= 128), up to MAX_RETRY times.
#
# Usage: tests/run_suite.sh [extra pytest args]
#
# The tests marked gpu skip on the CPU; `python chip_smoke.py` runs them
# on a card.

set -u
cd "$(dirname "$0")/.."
MAX_RETRY=${MAX_RETRY:-2}

FILES=(tests/test_*.py)

# Per-file timeout: one slow file must not starve the rest of the suite
# of its whole budget.
FILE_TMO=${SUITE_FILE_TMO:-1200}

fail=0
for f in "${FILES[@]}"; do
  for attempt in $(seq 0 "$MAX_RETRY"); do
    timeout "$FILE_TMO" python -m pytest "$f" -q -p no:cacheprovider "$@"
    rc=$?
    if [ "$rc" -eq 0 ]; then
      break
    elif [ "$rc" -eq 124 ]; then
      fail=1
      break
    elif [ "$rc" -ge 128 ] && [ "$attempt" -lt "$MAX_RETRY" ]; then
      echo "== $f died with signal (rc=$rc); retry $((attempt + 1))/$MAX_RETRY =="
    else
      fail=1
      break
    fi
  done
done
exit "$fail"
