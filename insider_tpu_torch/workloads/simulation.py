"""Simulation workload (tests/simulation.R:5-23 + simulation.rmd:19-74):
the planted-factor design (v1=50 x v2=5 levels, interaction, K=5), pure
lasso alpha=1, lambda=5, global_tol=1e-8; reports recovery R^2 vs the
noiseless signal."""

import numpy as np

from insider_tpu_torch.workloads.common import parse_args, save_fitted


def planted_r2(obj, sim) -> float:
    """R^2 of the fit's prediction against the noiseless planted signal."""
    codes = [np.unique(obj.confounder[:, i], return_inverse=True)[1]
             for i in range(obj.confounder.shape[1])]
    R = sum(V[c] for V, c in zip(obj.cfd_matrices, codes))
    pred = R @ obj.column_factor
    ss_res = float(np.sum((sim.expr - pred) ** 2))
    ss_tot = float(np.sum((sim.expr - sim.expr.mean()) ** 2))
    return 1 - ss_res / ss_tot


def main(argv=None):
    import insider_tpu_torch as itt

    args = parse_args("simulation", argv)
    sim = itt.simulate_insider_data(v1_num=50, v2_num=5,
                                    gene_num=args.synthetic_cols or 200,
                                    latent_dim=5, noise_std=1.0, seed=0)
    obj = itt.Insider(sim.data, sim.confounder[:, :2], interaction_idx=[0, 1],
                      split_ratio=0.1, global_tol=1e-8, sub_tol=1e-5,
                      max_iter=args.max_iter or 1000, device=args.device)
    obj = obj.fit(5, lambda_=5, alpha=1.0, partition=1)
    print(f"planted-signal R^2: {planted_r2(obj, sim):.4f}")
    save_fitted(obj, args.out or "insider_simulation_R5_fitted_object.npz")
    return obj


if __name__ == "__main__":
    obj = main()
