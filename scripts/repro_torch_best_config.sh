#!/usr/bin/env bash
# Reproduce one full kg -> batch-retrieve -> benchmark epoch for a pinned
# config (used to validate sweep-found optima; VERDICT r4 item 8 asks for
# the best sweep config reproduced twice).  Mirrors the sweep runner's
# subprocess protocol (scripts/run_parameter_sweep.py) for a single epoch.
#
# Usage: repro_best_config.sh WORKDIR CONFIG_YAML VLM_OUTPUT QUERIES
set -euo pipefail
WORKDIR=$1; CONFIG=$(readlink -f "$2"); VLM=$(readlink -f "$3"); QUERIES=$(readlink -f "$4")
REPO=$(readlink -f "$(dirname "$0")/..")
mkdir -p "$WORKDIR"; cd "$WORKDIR"
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
export PYTHONUNBUFFERED=1

echo "=== kg build ($(date -u +%H:%M:%S))"
python3 -m vidgraph_tpu_torch.cli.main kg --config "$CONFIG" --vlm-output "$VLM" \
  2>&1 | tee kg.log
UUID=$(grep -oE 'UUID: [0-9a-f-]{36}' kg.log | head -1 | cut -d' ' -f2)
echo "=== graph UUID: $UUID"

echo "=== batch-retrieve ($(date -u +%H:%M:%S))"
python3 -m vidgraph_tpu_torch.cli.main batch-retrieve --config "$CONFIG" \
  --graph-uuid "$UUID" --input "$QUERIES" --output retrieval.json \
  2>&1 | tee retrieve.log

echo "=== benchmark ($(date -u +%H:%M:%S))"
python3 -m vidgraph_tpu_torch.cli.main benchmark --config "$CONFIG" \
  --input retrieval.json --output benchmark.json 2>&1 | tee benchmark.log

python3 - <<'EOF'
import json
s = json.load(open("benchmark.json"))["statistics"]
print("REPRO RESULT:", json.dumps(s))
EOF
