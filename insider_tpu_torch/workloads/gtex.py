"""GTEx brain workload (tests/gtex.R:9-30): confounders (gender, structure)
+ interaction, K=12, lambda=60, alpha=0.5, global_tol=1e-10; the reference
runs 50 repeated tuning fits for stability -- set GTEX_REPEATS."""

import os

from insider_tpu_torch.workloads.common import (load_or_simulate, parse_args,
                                                save_fitted)


def main(argv=None):
    import insider_tpu_torch as itt

    args = parse_args("gtex", argv)
    data, conf = load_or_simulate(args, n_rows=600, level_counts=(2, 13),
                                  latent_dim=12, confounder_cols=2)
    obj = itt.Insider(data, conf, interaction_idx=[0, 1], global_tol=1e-10,
                      max_iter=args.max_iter or 1000, device=args.device)
    # stability runs: each repeat's fit draws its initial factors from its
    # own seed (Insider.fit reads obj.seed; tests/gtex.R:30)
    for rep in range(int(os.environ.get("GTEX_REPEATS", "1"))):
        obj.seed = rep
        obj = obj.fit(12, lambda_=60, alpha=0.5, partition=1)
        print(f"repeat {rep}: test_rmse={obj.test_rmse}")
    save_fitted(obj, args.out or "insider_gtex_R12_fitted_object.npz")
    return obj


if __name__ == "__main__":
    obj = main()
