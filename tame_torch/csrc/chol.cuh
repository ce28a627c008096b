// Sizes shared by the kernels that hold small d x d systems.
//
// K3 (fused_fit.cu) is instantiated for the d of r = 1..5; K1/K2 (spd.cu)
// and K4 (fused_smoother.cu) take every even d up to kMaxRuntimeD.
#pragma once

// Instantiated sizes of K3: d = 2 + 2r for r = 1..5.
#define TAME_FOR_EACH_D(X) X(4) X(6) X(8) X(10) X(12)

// Largest d of K1, K2 and K4; even d only.
constexpr int kMaxRuntimeD = 48;
