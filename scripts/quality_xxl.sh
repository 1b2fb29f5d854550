#!/bin/bash
# 10x-reference-catalog run: 470k items / 500k users / 365 days — scale
# the reference (47k-item H&M catalog, single GPU) cannot touch. Full
# stack on one accelerator; epochs trimmed to keep wall-clock ~2-3h.
# Later stages tolerate an earlier optional stage failing (partial
# results are still useful) but the final sentinel reports any failure.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_xxl
WD=$OUT/world
mkdir -p "$WD"
SETS="--set data.root=$WD --set data.num_items=470000 --set data.num_users=500000 --set data.days=365"
FAILED=""

run() {  # run <name> <timeout_s> <args...>
  local name=$1 tmo=$2; shift 2
  timeout "$tmo" python -m recsys.pipeline.cli "$@" $SETS \
    | tee "$OUT/$name.json" || FAILED="$FAILED $name"
}

JAX_PLATFORMS=cpu python -m recsys.pipeline.cli gen-data $SETS | tee "$OUT/gen.json" || exit 1
JAX_PLATFORMS=cpu python -m recsys.pipeline.cli etl $SETS | tee "$OUT/etl.json" || exit 1
run item 7200 train-item --set simcse.epochs=2
[ -z "$FAILED" ] || exit 1           # everything downstream needs vectors
run vectorize 3600 vectorize
[ -z "$FAILED" ] || exit 1
run user 14400 train-user --set user_train.epochs=8 --set user_train.ckpt_every=4
run gnn 10800 train-gnn --set gnn.epochs=3
run distill 3600 distill
run hybrid 14400 train-hybrid --set user_train.epochs=4 --set user_train.ckpt_every=2
run eval 7200 eval
if [ -n "$FAILED" ]; then echo "XXL-PARTIAL failed:$FAILED"; exit 1; fi
echo XXL-DONE
