// Host stand-in for CUDA's math_constants.h (see cuda_runtime.h here).
#pragma once

#include <limits>

#define CUDART_INF_F std::numeric_limits<float>::infinity()
#define CUDART_NAN_F std::numeric_limits<float>::quiet_NaN()
