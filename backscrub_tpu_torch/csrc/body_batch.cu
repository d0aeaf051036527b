// The persistent body kernel's stream-batch instantiations
// (body_mega_kernel<BF16, TERMS, true>, a batch of n_img > 1) and their
// launch, bs_body_mega_batch, which bs_body_mega calls: body_mega.cu
// compiled a second time with BS_BODY_BATCH, so that nvcc builds the batch
// kernels beside the one-image kernels rather than after them.
#define BS_BODY_BATCH 1
#include "body_mega.cu"
