"""Device ops: dense top-k over bf16 or int8 rows (kernels B1, B2), attention
(kernel B3), the IVF tier and its probe (kernel B4), f32-output matmuls and the
tensor-core product of the int8 probe (kernel B5)."""
