"""Post-processing analysis over converged meshes (sweeps, observables)."""
