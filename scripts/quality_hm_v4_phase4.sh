#!/bin/bash
# Round-4 campaign phase 4 — after the 25-epoch stage-2 run: the v4 eval
# grid (stage-2 + baselines + blend + significance + seasonal ablation;
# also persists the eval_uvecs sidecar) and the stage-2-pools rerank row.
# Bounded by a hard wall-clock stop so the chip is free for the driver's
# end-of-round bench.
set -u -o pipefail
cd "$(dirname "$0")/.."
OUT=artifacts/quality_hm_v4
WD=$OUT/world
STOP=${1:?stop epoch seconds}
SETS="--set data.root=$WD --set data.num_items=105000 --set data.num_users=1370000 \
 --set data.days=365 --set data.repeat_prob=0.10 --set data.name_style_words=2"
log() { echo "[$(date +%T)] $*" >> "$OUT/phase4.log"; }

# wait for the stage-2 long run to finish (deadline kill also counts —
# the best checkpoint is on disk either way). First wait for phase3's
# explicit start sentinel so a pgrep miss before the stage even launches
# can't send eval at a stale checkpoint (ADVICE r4). The sentinel is an
# UNTRACKED file, not a phase3.log line — the log is git-committed, so a
# grep would match stale round-4 lines after a wipe (code-review r5).
for i in $(seq 1 720); do
  [ -e "$OUT/.user_stage_started" ] && break
  [ -s "$OUT/user.rerun.json" ] && break
  sleep 10
done
for i in $(seq 1 1000); do
  [ -s "$OUT/user.rerun.json" ] && break
  pgrep -f "cli train-user" > /dev/null 2>&1 || break
  sleep 15
done
sleep 5

run() {  # run <name> <cmd...>  (timeout = time to STOP)
  local name=$1; shift
  local tmo=$(( STOP - $(date +%s) ))
  [ "$tmo" -gt 300 ] || { log "no time for $name"; return 1; }
  log "start $name (timeout ${tmo}s)"
  if timeout "$tmo" python -m recsys.pipeline.cli "$@" $SETS \
      2> >(tail -60 > "$OUT/$name.stderr") > "$OUT/$name.rerun.json.tmp"; then
    mv "$OUT/$name.rerun.json.tmp" "$OUT/$name.rerun.json"; log "done $name"
  else
    rm -f "$OUT/$name.rerun.json.tmp"; log "FAILED/timeout $name"; return 1
  fi
}

run eval eval
run rerank rerank-eval
log phase4-exit
