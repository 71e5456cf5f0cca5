"""Ops of the port: plain torch oracles (`core`), the CUDA kernels with their
plain versions (`kernels`, `encrypt_kernels`), their build (`_build`) and the
dispatch the public classes call (`dispatch`).  Importing builds nothing; the
kernels build at first launch."""
