// The generic engine step kernel's largest size class (up to the caps:
// kLargeNv dofs, kLargeNb bodies; the Ant model's worlds, a tree of more
// than 8 dofs, and a model whose candidate slots need a block for one
// env), a warp an env; engine_lane.cuh holds the device code,
// engine_lane.cu the C entry points.

#include "engine_lane.cuh"

ENGINE_CLASS_DISPATCH(engine_large_step, mmt_eng::kLargeNv,
                      mmt_eng::kLargeNb, 32)

// The phase counters of a profiling build (-DMMT_ENGINE_PHASES), or nothing.
ENGINE_PHASES_READER(mmt_engine_large_phases)
