"""Device ops: dense top-k (kernel B1), attention (kernel B3), f32-output matmuls."""
