// The lock-free union-find in global memory that ccl_union_find.cu's border
// pass and ccl_merge.cu's cross-cell merge share: a parent array of int32
// indices where a root is its own parent and every link points to a smaller
// index, so that each root is its tree's minimum in any order of the unions.
//
// find_halving() points each entry it passes at its grandparent; unite()
// finds both roots, links the larger under the smaller with atomicMin and,
// when the larger root was linked elsewhere meanwhile, retries from the
// parent atomicMin returns, so no link is lost.  Halving beside the atomics
// is safe: a store only replaces an entry's parent with one of its
// ancestors; an entry that has a parent below it never becomes a root
// again; and an atomicMin on an entry that was no longer a root returns its
// parent, from where its union retries.  Reads bypass L1 (__ldcg), since
// another SM may have just changed a parent; a stale one costs a retry.

#pragma once

#include <cuda_runtime.h>

// the root of i, pointing every entry on the way at its grandparent
__device__ __forceinline__ int find_halving(int* parent, int i) {
  int p = __ldcg(parent + i);
  while (p != i) {
    const int gp = __ldcg(parent + p);
    if (gp == p) return p;
    __stcg(parent + i, gp);
    i = gp;
    p = __ldcg(parent + i);
  }
  return i;
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_halving(parent, a);
    b = find_halving(parent, b);
    if (a == b) return;
    const int hi = a > b ? a : b;
    const int lo = a > b ? b : a;
    const int old = atomicMin(parent + hi, lo);
    if (old == hi) return;  // hi was a root and now hangs under lo
    a = old;                // hi had been linked to old < hi: unite old and lo
    b = lo;
  }
}
