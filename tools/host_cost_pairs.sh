#!/bin/bash
# Host ms per step of the port's decode step and training step, on another
# checkout of the repo (the parent) against this one, in the order parent,
# change, change, parent, so that both meet the same host in one run:
#
#     bash tools/host_cost_pairs.sh <parent checkout> [rounds]
#
# Each round runs tools/profile_torch_serving.py --steps 16 and
# tools/profile_torch_train.py --steps 5, float32 and --amp, in each tree.
# Prints the card, then each run's wall time and its host, device and peak
# memory lines; the tools' whole output goes to chiprun_out/host_cost.log.
# Needs a CUDA device; exits 1 if any run failed.
set -u
parent=${1:?usage: host_cost_pairs.sh <parent checkout> [rounds]}
rounds=${2:-1}
cd "$(dirname "$0")/.."
mkdir -p chiprun_out
log=chiprun_out/host_cost.log
out=$(mktemp)
: > "$log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
order=""
for _ in $(seq "$rounds"); do order="$order parent change change parent"; done
for who in $order; do
  d=.
  [ "$who" = parent ] && d=$parent
  for cmd in "tools/profile_torch_serving.py --steps 16" \
             "tools/profile_torch_train.py --steps 5" \
             "tools/profile_torch_train.py --steps 5 --amp"; do
    t0=$(date +%s.%N)
    (cd "$d" && python3 $cmd) > "$out" 2>&1 || { echo "FAILED $who $cmd"; rc=1; }
    t1=$(date +%s.%N)
    { echo "### $who: $cmd"; cat "$out"; } >> "$log"
    echo "$who | $cmd | $(python3 -c "print(round($t1 - $t0, 1))") s"
    grep -E "host|peak|Error" "$out" | sed "s/^/  /"
  done
done
rm -f "$out"
exit $rc
