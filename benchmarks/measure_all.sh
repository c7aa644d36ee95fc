#!/bin/bash
# Serialized measurement sweep on the GPU: one JAX process on the card at
# a time (each reserves most of its memory).  Every script exits non-zero
# when JAX finds no GPU.
# Usage: bash benchmarks/measure_all.sh [logfile]
LOG="${1:-chiprun_out/measure_all.log}"
cd "$(dirname "$0")/.."
mkdir -p "$(dirname "$LOG")"
run() {
  echo "== $*" | tee -a "$LOG"
  timeout 2500 env "$@" 2>>"$LOG" | tail -1 | tee -a "$LOG"
}
: > "$LOG"
run python bench.py
run BENCH_ORBIT=1 python bench.py
run BENCH_INSTANCED=1 python bench.py
run BENCH_SIZE=3840x2160 python bench.py
run BENCH_SIZE=3840x2160 BENCH_ORBIT=1 python bench.py
run BENCH_ORBIT=1 BENCH_SEQ=8 python bench.py
run BENCH_SIZE=3840x2160 BENCH_ORBIT=1 BENCH_SEQ=8 python bench.py
run BENCH_SIZE=3840x2160 BENCH_INSTANCED=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_CLIP=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_CLIP=1 BENCH_INSTANCED=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_CLIP=1 BENCH_INSTANCED=1 BENCH_U8=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_U8=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_DEPTH=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_ORBIT=1 BENCH_U8=1 python bench.py
run BENCH_SIZE=3840x2160 BENCH_ORBIT=1 BENCH_U8=1 BENCH_SEQ=8 python bench.py
echo "== run_configs 1-8" | tee -a "$LOG"
timeout 5400 python benchmarks/run_configs.py --configs 1,2,3,4,5,6,7,8 2>>"$LOG" | tee -a "$LOG"
echo "done" | tee -a "$LOG"
