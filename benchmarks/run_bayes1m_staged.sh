#!/bin/bash
# Supervisor for demo_bayes1m_staged.py: restart on stall aborts
# (exit 42) or crashes until DONE is printed, with a bounded number of
# attempts.  Progress is monotone via the stage checkpoint.
cd "$(dirname "$0")/.." || exit 1
LOG=${D1M_LOG:-chiprun_out/bayes1m_staged.log}
MAX_ATTEMPTS=${D1M_ATTEMPTS:-60}
for i in $(seq 1 "$MAX_ATTEMPTS"); do
  echo "=== attempt $i $(date +%H:%M:%S) ===" >> "$LOG"
  python benchmarks/demo_bayes1m_staged.py >> "$LOG" 2>&1
  rc=$?
  echo "=== attempt $i rc=$rc $(date +%H:%M:%S) ===" >> "$LOG"
  if grep -q "^DONE " "$LOG"; then
    echo "=== SUPERVISOR: complete ===" >> "$LOG"
    exit 0
  fi
  sleep 10
done
echo "=== SUPERVISOR: gave up after $MAX_ATTEMPTS attempts ===" >> "$LOG"
exit 1
