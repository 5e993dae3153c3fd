// K3's two variants share this: the convolution's shape, the plan that
// ops/quant_kernel.py::k3_plan computes on the host, and the launcher of
// the wgmma variant (csrc/quant_conv_wgmma.cu), which the entry point
// tmt_quant_conv (csrc/quant_conv.cu) calls.
#pragma once

#include <cuda_runtime.h>

enum : int { kWgmma = 0, kMmaSync = 1 };              // CONV_VARIANTS
enum : int { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2 };  // CONV_OUT_CODES

struct ConvShape {
  int b, h, w, ci, co, kh, kw;   // ci: padded input channels
};

// k3_plan's wgmma fields: the TMA box of x (box_w * box_h * box_b == 128
// output pixels in whole image rows), the output channels a tile, the
// persistent grid
struct ConvPlan {
  int box_w, box_h, box_b, bn, grid;
};

// Launch the wgmma variant; checks the plan against the shape and
// returns cudaErrorInvalidValue for one it cannot run.  sx: the
// activation scale (one float, or null for 1); sw, bias: (co,) floats
// (sw null for the int32 output).
int quant_conv_wgmma(const void* x, const void* w, const float* sx,
                     const float* sw, const float* bias, void* y,
                     const ConvShape& s, const ConvPlan& p, int out_dtype,
                     cudaStream_t stream);
