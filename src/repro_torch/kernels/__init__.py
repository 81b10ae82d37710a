"""Hand-written Hopper (sm_90a) CUDA kernels for IntSGD's hot spots, each
beside its plain PyTorch version (port of ``repro/kernels``):

  int_compress      g, α, seed       -> Int(α∘g) clipped   (1 read, 1 write)
  pack_words        image            -> PackedInt words
  unpack_words      summed words     -> summed image
  fused_unpack_sgd  words, p, m      -> p', m'  (decode + momentum SGD in one
                    pass; the summed image never touches device memory)

Sources live in ``repro_torch/csrc`` and are built with nvcc at first launch
(:mod:`repro_torch.kernels.build`); :mod:`repro_torch.kernels.ops` holds the
dispatching wrappers and their launch counts.
"""
