/* Batch window gather for the data loader's window cache (host code, a
 * counterpart of gather_windows in native/audio_native.c): rows of a
 * float32 arena of decoded audio, each given by its start and the samples
 * available from there, copied into an [rows, window] batch with the tail
 * of a short row zero-padded. One memcpy per row.
 *
 * A plain C interface, loaded with ctypes (data/native.py), which releases
 * the interpreter lock for the call, so loader threads copy while the
 * train step's thread dispatches.
 */

#include <stdint.h>
#include <string.h>

/* Returns 0, or 1 + the index of the first row out of the arena's bounds,
 * in which case nothing is written. */
int64_t gather_windows(const float *arena, int64_t arena_len, const int64_t *starts,
                       const int64_t *avail, int64_t rows, int64_t window, float *out) {
  for (int64_t r = 0; r < rows; r++) {
    int64_t s = starts[r];
    int64_t n = avail[r] < window ? avail[r] : window;
    /* Written so that no sum can overflow for corrupt int64 inputs. */
    if (s < 0 || n < 0 || s > arena_len || n > arena_len - s) return r + 1;
  }
  for (int64_t r = 0; r < rows; r++) {
    int64_t n = avail[r] < window ? avail[r] : window;
    float *dst = out + r * window;
    memcpy(dst, arena + starts[r], (size_t)n * sizeof(float));
    if (n < window) memset(dst + n, 0, (size_t)(window - n) * sizeof(float));
  }
  return 0;
}
