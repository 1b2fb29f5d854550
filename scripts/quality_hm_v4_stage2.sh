#!/bin/bash
# Round-4 campaign phase 2 — the full stack at the H&M shape on the
# content-realistic v4 world (hash stage-1 arm won phase 1's purity A/B:
# 0.0814 vs 0.0564). Order is risk-ranked: the GNN/hybrid/rerank chain
# (the headline system) first, then the 25-epoch stage-2 long-run
# (VERDICT r3 item 3 — resumable, per-epoch curve in metrics.jsonl),
# then eval + stage-2 rerank. Every stage tmp-then-mv guarded.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_hm_v4
WD=$OUT/world
SETS="--set data.root=$WD --set data.num_items=105000 --set data.num_users=1370000 \
 --set data.days=365 --set data.repeat_prob=0.10 --set data.name_style_words=2"
FAILED=""

run() {  # run <name> <timeout_s> <cmd...>
  local name=$1 tmo=$2; shift 2
  if [ -s "$OUT/$name.json" ]; then echo "skip $name"; return 0; fi
  if timeout "$tmo" python -m recsys.pipeline.cli "$@" $SETS \
      2> >(tail -60 > "$OUT/$name.stderr") | tee "$OUT/$name.json.tmp"; then
    mv "$OUT/$name.json.tmp" "$OUT/$name.json"
  else
    rm -f "$OUT/$name.json.tmp"; FAILED="$FAILED $name"
  fi
}

curve() {  # export the stage-2 per-epoch eval curve into committed space
  python - <<'EOF'
import json
rows = []
try:
    with open("artifacts/quality_hm_v4/world/ckpt_user/metrics.jsonl") as f:
        for line in f:
            r = json.loads(line)
            if r.get("kind") == "eval" or "recall@100" in r:
                rows.append(r)
except FileNotFoundError:
    pass
with open("artifacts/quality_hm_v4/user_curve.json", "w") as f:
    json.dump(rows, f, indent=1)
print(f"user_curve.json: {len(rows)} eval rows")
EOF
}

# ---- GNN chain + hybrid + hybrid rerank (the headline system)
run gnn 10800 train-gnn --set gnn.epochs=1 --set gnn.steps_per_epoch_max=1500
[ -z "$FAILED" ] || { echo "V4-STAGE2-FAILED:$FAILED"; exit 1; }
run gnn_eval 3600 gnn-eval
run distill 3600 distill
[ -z "$FAILED" ] || { echo "V4-STAGE2-FAILED:$FAILED"; exit 1; }
# rerun gnn-eval with the distilled rows now present
[ -s "$OUT/gnn_eval_distilled.json" ] || { rm -f "$WD/gnn_eval.json"; true; }
run gnn_eval_distilled 3600 gnn-eval
run hybrid 10800 train-hybrid --set user_train.epochs=2 \
  --set user_train.ckpt_every=1
[ -z "$FAILED" ] || { echo "V4-STAGE2-FAILED:$FAILED"; exit 1; }
run rerank_hybrid 10800 rerank-eval --vectors hybrid
run rerank_hybrid_1024 10800 rerank-eval --vectors hybrid --pool 1024 \
  --m-cos 600 --m-pop 200
# training-free baselines (content-profile row lands independent of stage-2)
if [ ! -s "$OUT/baselines.json" ]; then
  timeout 7200 python scripts/hm_baselines.py "$WD" \
    > "$OUT/baselines.json.tmp" 2> "$OUT/baselines.stderr" \
    && mv "$OUT/baselines.json.tmp" "$OUT/baselines.json" \
    || { rm -f "$OUT/baselines.json.tmp"; FAILED="$FAILED baselines"; }
fi

# ---- stage-2 long run (25 epochs, the reference's ep-26-best regime)
run user 25200 train-user --set user_train.epochs=25 \
  --set user_train.ckpt_every=1
curve
run eval 10800 eval
run rerank 10800 rerank-eval
curve
if [ -n "$FAILED" ]; then echo "V4-STAGE2-PARTIAL failed:$FAILED"; exit 1; fi
echo V4-STAGE2-DONE
