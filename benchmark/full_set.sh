#!/usr/bin/env bash
# Measure one cell as a bound is set: a first run (which builds and
# compiles), two sets of six runs on the same six seeds, and three traced
# runs, each its own process.  Result lines go to <out>/full_<cell>.jsonl,
# standard error to <out>/full_<cell>.err.
#   bash benchmark/full_set.sh <cell> <seconds> <first seed> <out>
set -u
W=$1; S=$2; BASE=$3; DIR=$4
OUT=$DIR/full_$W.jsonl; ERR=$DIR/full_$W.err
mkdir -p "$DIR"; : > "$OUT"; : > "$ERR"
run() {  # label seed trace
  echo "== $1 seed $2 trace $3" >> "$ERR"
  python3 -m benchmark.harness --workload "$W" --seed "$2" --seconds "$S" \
      --trace "$3" > "$DIR/full_run.out" 2>> "$ERR"
  rc=$?
  line=$(tail -n 1 "$DIR/full_run.out")
  echo "{\"label\": \"$1\", \"seed\": $2, \"trace\": $3, \"rc\": $rc, \"line\": ${line:-null}}" >> "$OUT"
}
run first $((BASE + 99)) 0
for set in A B; do
  for i in 1 2 3 4 5 6; do run "$set$i" $((BASE + i)) 0; done
done
for i in 1 2 3; do run "T$i" $((BASE + 50 + i)) 1; done
rm -f "$DIR/full_run.out"
