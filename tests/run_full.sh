#!/usr/bin/env bash
# Full-suite runner: the fast tier runs in one process; the slow tier runs
# PER-FILE in fresh subprocesses so one crashed interpreter can neither
# take down the rest of the suite nor hide which file failed. Exit status
# is non-zero if any tier fails. Usage: bash tests/run_full.sh
set -u
cd "$(dirname "$0")/.."
fails=0

echo "=== fast tier ==="
python -m pytest tests/ -q || fails=$((fails+1))

echo "=== slow tier (per-file subprocesses) ==="
slow_files=$(grep -rl "pytest.mark.slow" tests/test_*.py | sort)
for f in $slow_files; do
  echo "--- $f"
  python -m pytest "$f" -q -m slow || fails=$((fails+1))
done

if [ "$fails" -ne 0 ]; then
  echo "FULL SUITE: $fails tier/file failure(s)"
  exit 1
fi
echo "FULL SUITE: green"
