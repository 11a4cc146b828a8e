// Constants shared by the flash-attention forward (flash_fwd.cu) and
// backward (flash_bwd.cu) kernels, so the two cannot drift apart.
#pragma once

// Additive mask value of a masked key, as in the TPU kernel: not -inf or
// -1e9, because the backward rebuilds p = exp(s - lse) from the saved fp32
// lse, and a fully masked row must keep log(keys) beside it.
constexpr float kMaskVal = -1e5f;

// The forward's key tile.  Under causal masking the forward skips every
// key tile past the one that holds a row's 64-row tile, and the backward
// rebuilds p over exactly those tiles: p = 0 where key / kFlashKeyTile >
// row / kFlashKeyTile.  ops/flash_attention.CAUSAL_TILE mirrors it.
constexpr int kFlashKeyTile = 64;
