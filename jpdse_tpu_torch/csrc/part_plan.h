// The partitions of K3's partial-statistics launches (instance_norm.cu:
// instance_norm_stats_kernel and instance_norm_bwd_sums_kernel, then
// instance_norm_apply_kernel and instance_norm_bwd_dx_kernel), in plain C++:
// instance_norm.cu includes it and exports instance_norm_part_plan (and
// instance_norm_part_runs), from which the wrapper
// (ops/instance_norm.py::partial_plan) sizes the stats and sums launches'
// workspace, and instance_norm_apply_plan and instance_norm_apply_item; the
// CPU tests build this header alone with a host compiler to check the
// partitions (tests/test_torch_port_k3_partial_plan.py,
// tests/test_torch_port_k3_apply_plan.py). It is included by one
// translation unit of a library.
//
// The stats and sums: one CTA of kPartThreads threads per (slab, chunk): a
// slab is a batch element's channel tile of at most kPartTileWords words (a
// word: V channels, 16 bytes on the vector path), a chunk a run of whole
// stages of its rows, a stage kPartBatch words of each thread (pixel lanes x
// kPartBatch rows of the tile). A chunk is kPartMinStages stages at the
// least, more where the launch would have more than kPartMaxCtas CTAs. The
// knobs are macros so that a variant builds with -D
// (tools/torch_port_k3_partial_variants.py); so are the apply's and dx's
// (K3_APPLY_*, below).
#pragma once

#ifndef K3_PART_TILE_WORDS
#define K3_PART_TILE_WORDS 16
#endif
#ifndef K3_PART_TILE_MIN
#define K3_PART_TILE_MIN 4
#endif
#ifndef K3_PART_MERGE_BYTES
#define K3_PART_MERGE_BYTES 36864
#endif
#ifndef K3_PART_MIN_STAGES
#define K3_PART_MIN_STAGES 3
#endif
#ifndef K3_PART_MAX_CTAS
#define K3_PART_MAX_CTAS 132
#endif

#ifdef __CUDACC__
#define K3_HOST_DEVICE __host__ __device__
#else
#define K3_HOST_DEVICE
#endif

constexpr int kPartThreads = 256;
constexpr int kPartBatch = 4;  // words a thread folds from each stage
constexpr int kPartTileWords = K3_PART_TILE_WORDS;
constexpr int kPartTileMin = K3_PART_TILE_MIN;
constexpr int kPartMergeBytes = K3_PART_MERGE_BYTES;
constexpr int kPartMinStages = K3_PART_MIN_STAGES;
constexpr int kPartMaxCtas = K3_PART_MAX_CTAS;

struct PartPlan {
  long long hw, rows_per_chunk;
  int batch, c, groups, tile, tiles, pix, stage_rows, chunks;
};

// The plan at a tile of ``tile`` words.
inline PartPlan part_plan_at(long long hw, int batch, int c, int v, int tile) {
  PartPlan p{};
  p.hw = hw;
  p.batch = batch;
  p.c = c;
  p.groups = c / v;
  p.tile = tile;
  p.tiles = (p.groups + p.tile - 1) / p.tile;
  p.pix = kPartThreads / p.tile;
  p.stage_rows = kPartBatch * p.pix;
  const long long stages = (hw + p.stage_rows - 1) / p.stage_rows;
  const long long slabs = static_cast<long long>(batch) * p.tiles;
  const long long cap = slabs < kPartMaxCtas ? kPartMaxCtas / slabs : 1;  // chunks of a slab
  long long per = (stages + cap - 1) / cap;
  if (per < kPartMinStages) per = kPartMinStages;
  p.rows_per_chunk = per * p.stage_rows;
  // an empty slab (hw 0): one chunk of no rows, whose CTA writes the zero parts
  p.chunks = stages > 0 ? static_cast<int>((stages + per - 1) / per) : 1;
  return p;
}

// The tile. The merge after the last CTA's loads costs three dependent
// memory round trips on one SM whatever its size, and a tile narrower than
// 8 words (128 bytes of a row) slows the loads: so on the vector path, the
// widest tile of at least kPartTileMin words whose slabs take one chunk
// each (no merge) where the widest tile's do not; else the widest whose
// slab's partials (chunks x channels x 8 bytes) fit kPartMergeBytes, which
// the merging CTA reads in one batch; else the narrowest of at least
// kPartTileMin words. The one-word path takes the widest tile.
inline PartPlan make_part_plan(long long hw, int batch, int c, int v) {
  const int groups = c / v;
  const int widest = groups < kPartTileWords ? groups : kPartTileWords;
  const PartPlan first = part_plan_at(hw, batch, c, v, widest);
  if (v == 1 || first.chunks == 1) return first;
  for (int t = widest / 2; t >= kPartTileMin; t /= 2) {
    const PartPlan q = part_plan_at(hw, batch, c, v, t);
    if (q.chunks == 1) return q;
  }
  PartPlan p = first;
  for (int t = widest; t >= kPartTileMin || t == widest; t /= 2) {
    p = part_plan_at(hw, batch, c, v, t);
    if (static_cast<long long>(p.chunks) * t * v * 8 <= kPartMergeBytes || t / 2 < 1) break;
  }
  return p;
}

// The runs in which the merging CTA takes a slab's chunks for cs channels:
// with fewer channels than threads, each channel's chunks are cut into
// kPartThreads / cs contiguous runs, each merged in chunk order, then the
// runs in order; else one run.
K3_HOST_DEVICE inline int part_runs(int cs) { return cs < kPartThreads ? kPartThreads / cs : 1; }

extern "C" int instance_norm_part_runs(int cs) { return part_runs(cs); }

// The plan of a launch on (batch, hw, c) with v channels a word, into out:
// grid, chunks a slab, rows a chunk, words a tile, rows a stage, the fp32
// workspace (a (mean, M2) or two sums per (b, chunk, c)), the int counters
// (one a slab). Returns 0, or -1 for operands no launch takes.
extern "C" int instance_norm_part_plan(long long hw, int batch, int c, int v, long long* out) {
  if (batch < 1 || hw < 0 || c < 1 || v < 1 || c % v) return -1;
  const PartPlan p = make_part_plan(hw, batch, c, v);
  const long long slabs = static_cast<long long>(batch) * p.tiles;
  out[0] = slabs * p.chunks;
  out[1] = p.chunks;
  out[2] = p.rows_per_chunk;
  out[3] = p.tile;
  out[4] = p.stage_rows;
  out[5] = 2LL * batch * p.chunks * c;
  out[6] = slabs;
  return 0;
}

// -- the apply and dx launches --------------------------------------------------
//
// One CTA of kApplyThreads threads per (slab, chunk), CTAs in (b, tile,
// chunk) order: a slab is a batch element's channel tile of at most
// kApplyTileWords words, a chunk a contiguous run of its rows, the slab's
// rows cut into chunks as evenly as integers allow (chunk k's rows
// [hw k / chunks, hw (k + 1) / chunks)). A step is kApplyBatch rows of each
// pixel lane: the loads a thread issues before it uses any. The launch's
// target is a CTA for each kApplyCtaWords words (128 KiB of x on the vector
// path), at least kApplyCtas and at most kApplyMaxCtas; the launch bounds
// ask for kApplyMinBlocks CTAs an SM, so that the least target is one wave.
// A slab takes ceil(target / slabs) chunks, as far as its rows give each
// chunk kApplyMinSteps steps: a slab of fewer rows takes fewer chunks, an
// empty slab (hw 0) one chunk of no rows. The grid is then below the target
// plus one CTA a slab. On an H100 (PERF.md, PR 21) the largest slabs ran
// best at about 128 KiB of x a CTA, the others at two CTAs an SM.
#ifndef K3_APPLY_TILE_WORDS
#define K3_APPLY_TILE_WORDS 64
#endif
#ifndef K3_APPLY_BATCH
#define K3_APPLY_BATCH 4
#endif
#ifndef K3_APPLY_CTAS
#define K3_APPLY_CTAS 264
#endif
#ifndef K3_APPLY_MAX_CTAS
#define K3_APPLY_MAX_CTAS 1056
#endif
#ifndef K3_APPLY_CTA_WORDS
#define K3_APPLY_CTA_WORDS 8192
#endif
#ifndef K3_APPLY_MIN_STEPS
#define K3_APPLY_MIN_STEPS 1
#endif
#ifndef K3_APPLY_MIN_BLOCKS
#define K3_APPLY_MIN_BLOCKS 2
#endif

constexpr int kApplyThreads = 256;
constexpr int kApplyTileWords = K3_APPLY_TILE_WORDS;
constexpr int kApplyBatch = K3_APPLY_BATCH;
constexpr long long kApplyCtas = K3_APPLY_CTAS;
constexpr long long kApplyMaxCtas = K3_APPLY_MAX_CTAS;
constexpr long long kApplyCtaWords = K3_APPLY_CTA_WORDS;
constexpr int kApplyMinSteps = K3_APPLY_MIN_STEPS;
constexpr int kApplyMinBlocks = K3_APPLY_MIN_BLOCKS;
static_assert(kApplyTileWords <= kApplyThreads, "a tile's words need a thread each");
static_assert(kApplyCtaWords > 0 && kApplyCtas <= kApplyMaxCtas, "the target's bounds");

// The launch's target CTAs: one for each kApplyCtaWords of the batch's
// words, between kApplyCtas and kApplyMaxCtas.
K3_HOST_DEVICE inline long long apply_target(long long hw, int batch, int groups) {
  const long long by_words = (batch * hw * groups + kApplyCtaWords - 1) / kApplyCtaWords;
  return by_words < kApplyCtas ? kApplyCtas : by_words < kApplyMaxCtas ? by_words : kApplyMaxCtas;
}

struct ApplyPlan {
  long long hw;
  int batch, c, groups, tile, tiles, pix, step_rows, chunks;
};

K3_HOST_DEVICE inline ApplyPlan make_apply_plan(long long hw, int batch, int c, int v) {
  ApplyPlan p{};
  p.hw = hw;
  p.batch = batch;
  p.c = c;
  p.groups = c / v;
  p.tile = p.groups < kApplyTileWords ? p.groups : kApplyTileWords;
  p.tiles = (p.groups + p.tile - 1) / p.tile;
  p.pix = kApplyThreads / p.tile;
  p.step_rows = kApplyBatch * p.pix;
  const long long slabs = static_cast<long long>(batch) * p.tiles;
  const long long steps = (hw + p.step_rows - 1) / p.step_rows;
  const long long want = (apply_target(hw, batch, p.groups) + slabs - 1) / slabs;
  const long long most = steps / kApplyMinSteps;  // chunks of kApplyMinSteps steps
  const long long chunks = want < most ? want : most;
  p.chunks = chunks > 1 ? static_cast<int>(chunks) : 1;
  return p;
}

// CTA q's chunk: batch element, channel tile, the tile's words (its last
// may be narrower), rows [r0, r1).
struct ApplyItem {
  int b, t, words, chunk;
  long long r0, r1;
};

K3_HOST_DEVICE inline ApplyItem apply_item(const ApplyPlan& p, long long q) {
  ApplyItem it;
  it.chunk = static_cast<int>(q % p.chunks);
  const long long slab = q / p.chunks;
  it.b = static_cast<int>(slab / p.tiles);
  it.t = static_cast<int>(slab % p.tiles);
  const int rest = p.groups - it.t * p.tile;
  it.words = rest < p.tile ? rest : p.tile;
  it.r0 = p.hw * it.chunk / p.chunks;
  it.r1 = p.hw * (it.chunk + 1) / p.chunks;
  return it;
}

// The plan of an apply or dx launch on (batch, hw, c) with v channels a
// word, into out: grid, chunks a slab, rows a chunk (the most), words a
// tile, the CTAs' target (apply_target), rows a step. Returns 0, or -1 for operands no
// launch takes.
extern "C" int instance_norm_apply_plan(long long hw, int batch, int c, int v, long long* out) {
  if (batch < 1 || hw < 0 || c < 1 || v < 1 || c % v) return -1;
  const ApplyPlan p = make_apply_plan(hw, batch, c, v);
  out[0] = static_cast<long long>(batch) * p.tiles * p.chunks;
  out[1] = p.chunks;
  out[2] = (hw + p.chunks - 1) / p.chunks;
  out[3] = p.tile;
  out[4] = apply_target(hw, batch, p.groups);
  out[5] = p.step_rows;
  return 0;
}

// CTA q's (batch element, first and end channel, first and end row) in the
// same launch, into out. Returns 0, or -1 for operands no launch takes or a
// q outside the grid.
extern "C" int instance_norm_apply_item(long long hw, int batch, int c, int v, long long q,
                                        long long* out) {
  if (batch < 1 || hw < 0 || c < 1 || v < 1 || c % v) return -1;
  const ApplyPlan p = make_apply_plan(hw, batch, c, v);
  if (q < 0 || q >= static_cast<long long>(batch) * p.tiles * p.chunks) return -1;
  const ApplyItem it = apply_item(p, q);
  const long long g0 = static_cast<long long>(it.t) * p.tile;
  out[0] = it.b;
  out[1] = g0 * v;
  out[2] = (g0 + it.words) * v;
  out[3] = it.r0;
  out[4] = it.r1;
  return 0;
}
