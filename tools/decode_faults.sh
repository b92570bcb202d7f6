#!/bin/sh
# Planted faults of the split-KV decode kernels.  Each is a sed edit of a
# fresh copy of this tree's chip_smoke.py and src/, run through the whole
# chip_smoke.py, which must fail in its kernel phase (before the small
# references start).  Run from the repository root on a machine with one
# GPU:
#
#     sh tools/decode_faults.sh [WORK_DIR]     # default build/faults
#
# Prints each fault's exit code and the last lines of its output; exits
# non-zero if any fault passes or fails outside the kernel phase.
set -u
WORK=${1:-build/faults}
KERN=src/repro_torch/kernels/decode_attention.py
CU=src/repro_torch/csrc/decode_attention.cu
COMMON=src/repro_torch/csrc/decode_common.cuh
status=0

plant() {   # name, file, sed script[, file, sed script]
  name=$1; shift
  d=$WORK/$name
  rm -rf "$d" && mkdir -p "$d" && cp -r chip_smoke.py src "$d"/
  while [ $# -ge 2 ]; do
    sed -i "$2" "$d/$1"
    if cmp -s "$1" "$d/$1"; then
      echo "$name: the edit of $1 changed nothing"; status=1; return
    fi
    shift 2
  done
  (cd "$d" && timeout 600 python3 chip_smoke.py > out.txt 2>&1)
  rc=$?
  echo "== $name: exit $rc"
  tail -n 3 "$d/out.txt"
  if [ $rc -eq 0 ] || grep -q "small reference" "$d/out.txt"; then
    echo "$name: NOT caught in the kernel phase"; status=1
  fi
}

# D1: the plan drops the last split (the C entry's coverage check
# refuses the launch) ...
plant D1 $KERN 's|^\(    T, n_split = decode_split_plan(.*)\)$|\1\n    n_split -= 1|'
# ... and D1b: the same with that check removed (the comparison fails).
plant D1b $KERN 's|^\(    T, n_split = decode_split_plan(.*)\)$|\1\n    n_split -= 1|' \
  $CU 's/ || static_cast<int64_t>(n_split) \* T < S//'
# D2: the split body ignores the kv_len mask.
plant D2 $COMMON '/if (t0 + t >= mask_len) part = kNegInf;/d'
# D3: the merge skips split 0's max correction.
plant D3 $COMMON 's|const float c = expf(m_part\[p0 + s\] - M);|const float c = s == 0 ? 1.f : expf(m_part[p0 + s] - M);|'
exit $status
