/* Shared declarations for the native intra predictors (vvc_intra.c) so the
 * recon core (vvc_recon.c) can drive them in-process. */
#ifndef VVC_INTRA_H
#define VVC_INTRA_H

#include <stdint.h>

/* pad offset of the left/top int64 edge buffers (index PADC == position 0) */
#define VVC_EDGE_PAD 192
#define VVC_EDGE_BUF 512

void vvc_fill_edges(const int32_t *plane, long stride, int x, int y,
                    int ref_line, int left_avail, int top_avail,
                    int cand_up_left, int unf_left, int unf_top,
                    int left_size, int top_size, int do_smoothing,
                    int bit_depth, int64_t *left, int64_t *top);

void vvc_intra_pred(int32_t *plane, long stride, int x, int y, int w, int h,
                    int c_idx, int mode, int ref_idx, int pdpc,
                    int do_smoothing, int left_size, int top_size,
                    int unf_left, int unf_top, int refw, int refh,
                    int angle, int inv_angle, int filter_flag, int nscale,
                    int left_avail, int top_avail, int cand_up_left,
                    int bit_depth, const int32_t *fc_filt,
                    const int32_t *fg_filt);

void vvc_dequant_flat(int32_t *c, int n, long long scale_x_m,
                      long long bd_offset, int bd_shift, int lo, int hi);

#endif /* VVC_INTRA_H */
