// Device timestamps inside a CUDA graph (sm_90a).
//
// A CUDA event recorded inside a captured graph is one node: every replay
// stamps it again, so after a run of replays only the last one can be read.
// This kernel writes the device's global nanosecond timer (%globaltimer)
// into a ring of rows instead, one row a replay: column k of row
// (*index mod rows), and the stamp of the last column moves *index on.  A
// replay of a graph that holds the stamps 0 .. cols - 1, in stream order,
// fills one row; after any number of replays the host reads the last `rows`
// of them, at its next synchronisation.
//
// One thread: a stamp's work is its place in the stream.  The timer is one
// clock for the whole device, in nanoseconds (its resolution is the card's,
// a microsecond or finer).

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* table, int* index, int rows, int cols, int col) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned int at = static_cast<unsigned int>(*index);
  table[static_cast<long long>(at % rows) * cols + col] = static_cast<long long>(now);
  if (col == cols - 1) *index = static_cast<int>(at + 1);
}

}  // namespace

extern "C" {

// table (rows, cols) int64 and index () int32, on the current device;
// 0 <= col < cols.  Returns the cudaGetLastError() code after the launch (0
// on success), or cudaErrorInvalidValue without launching.
int gbn_stamp(long long* table, int* index, int rows, int cols, int col, void* stream) {
  if (rows < 1 || cols < 1 || col < 0 || col >= cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(table, index, rows, cols, col);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
