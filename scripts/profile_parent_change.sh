#!/usr/bin/env bash
# Trace one step of a parent tree and of this tree on the same card, in
# the order parent, change, change, parent, with
# scripts/profile_torch_step.py (each tree runs its own copy and builds
# its own kernels).
#
#   scripts/profile_parent_change.sh PARENT_DIR NAME [profile flags...]
#
# PARENT_DIR: the parent commit unpacked inside this tree, in a directory
# .gitignore lists, e.g.
#   mkdir -p _archive/parent && git archive HEAD | tar -x -C _archive/parent
# The flags go to profile_torch_step.py as they are: "--steps 5" for the
# block-major bf16 step, "--path train --packed --steps 4" for the packed
# training step.  Each run writes chiprun_out/NAME_<i>_<tree>.log and
# .json (i = 1..4, tree = parent or change).
set -euo pipefail
parent=$(cd "$1" && pwd)
name=$2
shift 2
here=$(cd "$(dirname "$0")/.." && pwd)
out="$here/chiprun_out"
mkdir -p "$out"
i=0
for tree in parent change change parent; do
  i=$((i + 1))
  dir=$here
  if [ "$tree" = parent ]; then dir=$parent; fi
  (cd "$dir" && python3 scripts/profile_torch_step.py "$@" \
      --json "$out/${name}_${i}_${tree}.json") \
      > "$out/${name}_${i}_${tree}.log" 2>&1
  grep -E "^(untraced|traced|  )" "$out/${name}_${i}_${tree}.log" \
      | head -n 16 | sed "s/^/[$i $tree] /"
done
