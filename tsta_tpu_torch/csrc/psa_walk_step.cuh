// One step of the PSA traceback walk, shared by psa_walk.cu (a whole
// plane per pair) and psa_walk_bounded.cu (one chunk of one pair's plane).
//
// The rules of tsta_tpu/ops/traceback.py:_decode_step (and the port's
// ops/traceback.decode_step): inside the matrix the move is the forced one
// if the previous step forced it, else the cell's back code (1 diag, 0
// left, 2 up); a left move forces the next move left when the cell's f
// code is 0 (extend) or the entered cell's f code is 2 (open with a tie),
// an up move likewise with e codes (the reference's plane rewrite).
#pragma once

namespace tsta {

// The move at cell (i, j), i >= 0 and j >= 0, with code ``code``, the f
// code source ``left`` (the code of (i, j-1), any value when j == 0) and
// the e code source ``up`` (the code of (i-1, j), any value when i == 0).
// ``forced`` is 0 or the forced move + 1; ``next`` gets the next step's.
__device__ __forceinline__ int psa_walk_step(int code, int left, int up,
                                             int i, int j, int forced,
                                             int& next) {
  const int move = forced > 0 ? forced - 1 : code / 9;
  next = 0;
  if (move == 0 && j > 0) {
    if ((code / 3) % 3 == 0 || (left / 3) % 3 == 2) next = 1;
  } else if (move == 2 && i > 0) {
    if (code % 3 == 0 || up % 3 == 2) next = 3;
  }
  return move;
}

}  // namespace tsta
