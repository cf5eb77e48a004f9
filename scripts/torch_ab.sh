#!/usr/bin/env bash
# Times two trees of the PyTorch port on one card, in turns: A, B, B, A.
#
#   scripts/torch_ab.sh A_DIR B_DIR [chip_smoke.py arguments]
#
# Each directory is a checkout of the repo; for the parent commit, unpack
# `git archive <parent>` into a git-ignored directory of this checkout
# (/_exp/ or /_tree_check/).  The script runs `python3 chip_smoke.py` from
# each tree in the order A B B A, so that both are measured on one card in
# one session, and keeps each run's output and chiprun_out/chip_smoke.json
# as chiprun_out/ab/{a1,b1,b2,a2}.{log,json} under the current directory.
# It prints each run's K2 and serving lines and exits non-zero if a run fails.
set -u -o pipefail
a=$(cd "$1" && pwd)
b=$(cd "$2" && pwd)
shift 2
out=$PWD/chiprun_out/ab
mkdir -p "$out"
rc=0
for run in a1 b1 b2 a2; do
  case $run in a*) dir=$a ;; *) dir=$b ;; esac
  if ! (cd "$dir" && python3 chip_smoke.py "$@") > "$out/$run.log" 2>&1; then
    echo "$run ($dir) failed: see $out/$run.log"
    rc=1
  fi
  cp "$dir/chiprun_out/chip_smoke.json" "$out/$run.json" 2>/dev/null
  echo "== $run ($dir)"
  grep -aE '^(mrf_round |serve: |train: |NVIDIA)' "$out/$run.log"
done
exit $rc
