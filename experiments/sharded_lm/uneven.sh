#!/bin/sh
# The splits that the mesh does not divide evenly, on four cards of one
# host, each against one card's unsharded step (run.py's --one-card,
# serve.py's period part), in float32 compute where a check is made:
#   1-4: query heads fewer than "model": nemotron-4-15b with 2 heads over
#     1 KV head, minicpm3-4b with 2 MLA heads, at 2 layers, (1, 4):
#     train_4k 2 x 4,096, then the serving period;
#   5-8: nemotron-4-15b at 2 layers over (1, 4): train_4k at sequences of
#     4,096 (even) and 4,094 (blocks 1,024 x 3 and 1,022), the prefill at
#     4,096 and 4,094 (chunk_q 2,048 and 2,047: it must divide the
#     sequence);
#   9: microbatches of 6 over 4 data ranks (a global batch of 12 in the
#     dense model's 2: rows 2, 2, 2 and 0);
#   10: qwen3-moe at 1 layer, 4,094 tokens a microbatch: gcd(4094, 32) = 2
#     MoE groups over 4 data ranks.
# One JSON line a run in $OUT (default uneven.jsonl), each
# run's log in $OUT.logs/; a run that fails adds {"failed": ...} and the
# others go on.  Further arguments pick runs by number, in their order.
#
#     sh experiments/sharded_lm/uneven.sh [OUT [N ...]]
OUT=${1:-uneven.jsonl}
[ $# -gt 0 ] && shift
LOGS=$OUT.logs
mkdir -p "$LOGS"
: > "$OUT"
export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True
T="torchrun --standalone --nproc-per-node 4"
D=experiments/sharded_lm
N=0
run() {
    N=$((N + 1))
    echo "== $N: $*" >&2
    if "$@" > "$LOGS/$N.log" 2>&1; then
        grep '^{' "$LOGS/$N.log" >> "$OUT"
    else
        echo "{\"failed\": \"$*\", \"log\": \"$LOGS/$N.log\"}" >> "$OUT"
        tail -5 "$LOGS/$N.log" >&2
    fi
}
R="run.py --arch nemotron-4-15b --layers 2 --meshes 1x4 --batch 2 --steps 2
   --one-card grads --f32"
P="serve.py --parts period --arch nemotron-4-15b --period-layers 2
   --cells prefill_32k --meshes 1x4"
case_n() {
    case $1 in
    1) run $T $D/$R --heads 2 --kv-heads 1 ;;
    2) run $T $D/serve.py --parts period --arch nemotron-4-15b \
           --period-layers 2 --heads 2 --kv-heads 1 --meshes 1x4 ;;
    3) run $T $D/run.py --arch minicpm3-4b --layers 2 --meshes 1x4 \
           --heads 2 --batch 2 --steps 2 --one-card grads --f32 ;;
    4) run $T $D/serve.py --parts period --arch minicpm3-4b \
           --period-layers 2 --heads 2 --meshes 1x4 ;;
    5) run $T $D/$R --seq 4096 --chunk-q 2048 ;;
    6) run $T $D/$R --seq 4094 --chunk-q 2047 ;;
    7) run $T $D/$P --seq 4096 --chunk-q 2048 ;;
    8) run $T $D/$P --seq 4094 --chunk-q 2047 ;;
    9) run $T $D/run.py --arch nemotron-4-15b --layers 2 --meshes 4x1 \
           --batch 12 --xent-chunk 4096 --steps 2 \
           --one-card grads --f32 ;;
    10) run $T $D/run.py --arch qwen3-moe-235b-a22b --layers 1 \
            --meshes 4x1 --seq 4094 --chunk-q 2047 --batch 8 --steps 2 \
            --one-card grads --f32 ;;
    esac
}
for n in ${*:-1 2 3 4 5 6 7 8 9 10}; do
    N=$((n - 1))
    case_n "$n"
done
cat "$OUT"
