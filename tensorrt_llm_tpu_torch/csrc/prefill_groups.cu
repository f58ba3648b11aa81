// K2, the ragged prefill kernels (csrc/prefill_attention.cu), with the
// image-group or-mask compiled in: the image-group VLMs' prompt steps
// (Gemma 3's images, PaliGemma's whole prompt; the JAX package's dense
// or-mask, ops/attention.py:568-586). Its own library, so that the text
// path's kernels stay as they were; entry ragged_prefill_attention_groups,
// for pools of q's type (bf16 on the tensor-core route, float32 on the
// CUDA-core one). ops/cuda/prefill_attention.py launches it for a call
// with q_groups.
#define PREFILL_GROUPS 1
#include "prefill_attention.cu"
