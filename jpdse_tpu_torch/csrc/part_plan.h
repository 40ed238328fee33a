// The partition of K3's partial-statistics stats and sums launches
// (instance_norm.cu: instance_norm_stats_kernel, instance_norm_bwd_sums_kernel),
// in plain C++: instance_norm.cu includes it and exports
// instance_norm_part_plan (and instance_norm_part_runs), from which the wrapper
// (ops/instance_norm.py::partial_plan) sizes the launches' workspace, and
// the CPU tests build this header alone with a host compiler to check the
// partition (tests/test_torch_port_k3_partial_plan.py). It is included by
// one translation unit of a library.
//
// One CTA of kPartThreads threads per (slab, chunk): a slab is a batch
// element's channel tile of at most kPartTileWords words (a word: V channels,
// 16 bytes on the vector path), a chunk a run of whole stages of its rows,
// a stage kPartBatch words of each thread (pixel lanes x kPartBatch rows of
// the tile). A chunk is kPartMinStages stages at the least, more where the
// launch would have more than kPartMaxCtas CTAs. The knobs are macros so
// that a variant builds with -D (tools/torch_port_k3_partial_variants.py).
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
