"""Hand-written Hopper (sm_90a) CUDA kernels for IntSGD's hot spots, each
beside its plain PyTorch version (port of ``repro/kernels``):

  int_compress      g, α, seed       -> Int(α∘g) clipped   (1 read, 1 write)
  pack_words        image            -> PackedInt words
  unpack_words      summed words     -> summed image
  fused_unpack_sgd  words, p, m      -> p', m'  (decode + momentum SGD in one
                    pass; the summed image never touches device memory)
  fused_unpack_adamw words, p, mu, nu -> p', mu', nu'  (decode + AdamW)
  fused_apply_sgd   int8/16/32 lanes, p, m -> p', m'   (dense-lane decode)
  fused_apply_adamw int8/16/32 lanes, p, mu, nu -> p', mu', nu'
  (each fused kernel optionally takes the IntDIANA shift h and also
  returns h' = Σints/(nα) + h)
  block_norms       x (f32 or int32)  -> Σx² per contiguous chunk, f32
                    (||Δx_l||² for the α rules, ||Σints_l||² for the clip)

Sources live in ``repro_torch/csrc`` and are built with nvcc at first launch
(:mod:`repro_torch.kernels.build`); :mod:`repro_torch.kernels.ops` holds the
dispatching wrappers and their launch counts.
"""
