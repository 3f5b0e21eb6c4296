// The generic engine step kernel's middle size class (kMidNv dofs, kMidNb
// bodies, no tree of more than 8 dofs: the Roller with a block or a ball,
// the arm, the twin roller), 8 lanes an env; engine_lane.cuh holds the
// device code, engine_lane.cu the C entry points.

#include "engine_lane.cuh"

ENGINE_CLASS_DISPATCH(engine_mid_step, mmt_eng::kMidNv, mmt_eng::kMidNb, 8)

// The phase counters of a profiling build (-DMMT_ENGINE_PHASES), or nothing.
ENGINE_PHASES_READER(mmt_engine_mid_phases)
