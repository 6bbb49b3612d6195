#!/bin/bash
# The whole chip_smoke.py of two or more checkouts in one card session, in
# the order given (a checkout named twice runs twice), each timed on the
# host clock, with its phase lines:
#
#   git archive <parent> | tar -x -C build/parent   (likewise build/change)
#   bash scripts/chip_smoke_ab.sh build/change build/parent build/parent build/change
#
# AB_PHASES runs only the named phase functions of chip_smoke.py instead
# (after phase_device and phase_build), each in the order given, with its
# host seconds and the process's CPU seconds:
#
#   AB_PHASES="phase_llm phase_pretrained phase_moe phase_gbdt_surface" \
#     bash scripts/chip_smoke_ab.sh build/parent build/change build/change build/parent
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
  if [ -n "${AB_PHASES:-}" ]; then
    (cd "$dir" && python3 - "$AB_PHASES" > "$log" 2>&1 <<'EOF'
import sys
import time

import chip_smoke as c

card, device = c.phase_device()
c.phase_build()
for name in sys.argv[1].split():
    t0, cpu0 = time.perf_counter(), time.process_time()
    getattr(c, name)(device, card)
    print(f"[phase] {name} done in {time.perf_counter() - t0:.1f} s "
          f"(process CPU {time.process_time() - cpu0:.1f} s)", flush=True)
print("[phase] all done")
EOF
    )
  else
    (cd "$dir" && python3 chip_smoke.py > "$log" 2>&1)
  fi
  rc=$?
  t1=$(date +%s.%N)
  echo "run $run: $dir rc=$rc seconds=$(python3 -c "print(round($t1 - $t0, 1))")"
  grep -E "^\[phase\]" "$log"
  tail -n 1 "$log"
done
