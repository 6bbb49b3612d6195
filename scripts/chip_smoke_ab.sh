#!/bin/bash
# The whole chip_smoke.py of two or more checkouts in one card session, in
# the order given (a checkout named twice runs twice), each timed on the
# host clock, with its phase lines:
#
#   git archive <parent> | tar -x -C build/parent   (likewise build/change)
#   bash scripts/chip_smoke_ab.sh build/change build/parent build/parent build/change
#
# Full logs go to $AB_LOG_DIR/smoke_<run>_<dir name>.log (default ab_logs).
# Compare two trees only within one session, and run them in both orders.
set -u
logs="$PWD/${AB_LOG_DIR:-ab_logs}"
mkdir -p "$logs"
run=0
for dir in "$@"; do
  run=$((run + 1))
  log="$logs/smoke_${run}_$(basename "$dir").log"
  t0=$(date +%s.%N)
  (cd "$dir" && python3 chip_smoke.py > "$log" 2>&1)
  rc=$?
  t1=$(date +%s.%N)
  echo "run $run: $dir rc=$rc seconds=$(python3 -c "print(round($t1 - $t0, 1))")"
  grep -E "^\[phase\]" "$log"
  tail -n 1 "$log"
done
