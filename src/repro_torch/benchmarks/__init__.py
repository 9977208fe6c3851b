"""The paper's quality measurements on the port (ports of the top-level
``benchmarks/``): trained stand-ins, hook ΔPPL, static λ, Table 7."""
