"""Ageing workload (tests/ageing.R:13-47): 377 samples, 3 confounders
(pid/sid/did) + interaction of the first two, K=24, lambda=11, alpha=0.4,
global_tol=1e-10, max_iter=1000."""

from insider_tpu_torch.workloads.common import (load_or_simulate, parse_args,
                                                save_fitted)


def main(argv=None):
    import insider_tpu_torch as itt

    args = parse_args("ageing", argv)
    data, conf = load_or_simulate(args, n_rows=377, level_counts=(2, 8, 107),
                                  latent_dim=24, confounder_cols=3)
    obj = itt.Insider(data, conf, interaction_idx=[0, 1], global_tol=1e-10,
                      sub_tol=1e-5, tuning_iter=30,
                      max_iter=args.max_iter or 1000, device=args.device)
    obj = obj.fit(24, lambda_=11, alpha=0.4, partition=1)
    save_fitted(obj, args.out or "insider_ageing_R24_fitted_object.npz")
    return obj


if __name__ == "__main__":
    obj = main()
