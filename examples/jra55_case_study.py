#!/usr/bin/env python
"""End-to-end JRA-55 hgt500 case study on synthetic data.

The reference's combined JRA-55 analysis notebook
(`notebooks/jra55_hgt500_pca_combined.ipynb`) is a stripped large blob
upstream (reference .MISSING_LARGE_BLOBS:1); this script is its
runnable reconstruction from the surviving drivers' contracts
(reference bin/run_jra55_{kmeans,pca_aa,pca_gpnh,pca_kmeans}.py): the
full gridded-data -> EOF/PC -> PC-space-factorization -> grid-pattern
analysis chain in one zero-egress script:

    python examples/jra55_case_study.py /tmp/jra55_case_study

Steps:
  1. synthesize a JRA-55-schema hgt500 anomaly grid
     (bin/make_synthetic_jra55.py)
  2. jra55_pca driver: EOFs + PCs netCDF product
  3. PC-space drivers: jra55_pca_aa, jra55_pca_gpnh, jra55_pca_kmeans
     (gap statistic, PCA reference), plus gridded jra55_kmeans
  4. notebook-analog analysis: project PC-space states back to grid
     patterns through the EOFs, sort every method's states by pattern
     correlation against the leading EOFs, cross-match AA archetypes
     with k-means centroids, and write the artifact inventory —
     per-method grid-state maps (PNG), the state-sorting and
     cross-method match tables (CSV), and the AA model-selection CSV
     + curve.

Pass ``--platform cpu`` to force the CPU backend (threaded through to
every driver; useful for quick validation without a GPU) and ``--quick`` to
shrink every knob for CI smoke tests of the full chain (same steps,
same artifacts).
"""

import argparse
import csv
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

K = 4        # states per method
N_MODES = 6  # EOF truncation


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('out_dir', nargs='?',
                        default='/tmp/jra55_case_study')
    parser.add_argument('--platform', default=None,
                        choices=['cpu', 'gpu'])
    parser.add_argument('--quick', action='store_true',
                        help='CI smoke mode: smaller grid, fewer '
                             'restarts/trials/iterations, same steps '
                             'and artifacts')
    args = parser.parse_args()
    quick = args.quick
    os.makedirs(args.out_dir, exist_ok=True)
    platform = (['--platform', args.platform] if args.platform else [])

    def sh(*cmd):
        print("+", " ".join(cmd))
        subprocess.run(list(cmd), check=True, cwd=REPO)

    def driver(name, in_path, *extra):
        out = os.path.join(args.out_dir, f"{name}.nc")
        sh(sys.executable, "-m", "convex_dim_red_tpu.cli.drivers", name,
           in_path, out, "--random-seed", "0", *extra, *platform)
        return out

    py = sys.executable
    grid = os.path.join(args.out_dir, "hgt500_anom.nc")
    grid_args = (["--n-years", "8", "--n-lat", "12", "--n-lon", "24"]
                 if quick else ["--n-years", "20"])
    sh(py, "bin/make_synthetic_jra55.py", grid, "--kind", "grid",
       *grid_args)

    max_iter = "120" if quick else "300"

    # EOF/PC product (the input to all three PC-space drivers).
    pca = driver("jra55_pca", grid, "--n-components", str(N_MODES))

    k = str(K)
    aa = driver("jra55_pca_aa", pca, "--n-components", k,
                "--n-init", "4" if quick else "8",
                "--tolerance", "1e-6", "--max-iterations", max_iter)
    gpnh = driver("jra55_pca_gpnh", pca, "--n-components", k,
                  "--n-init", "2" if quick else "4",
                  "--lambda-W", "1e-3",
                  "--tolerance", "1e-6", "--max-iterations", max_iter)
    pc_km = driver("jra55_pca_kmeans", pca, "--n-components", k,
                   "--n-init", "4" if quick else "10",
                   "--n-trials", "8" if quick else "20",
                   "--reference", "pca")
    grid_km = driver("jra55_kmeans", grid, "--n-components", k,
                     "--n-init", "4" if quick else "10",
                     "--n-trials", "8" if quick else "20")

    # ---- combined analysis (the missing notebook's content) -------------
    from convex_dim_red_tpu.pipelines.analysis import (
        pattern_correlation, sort_states, write_model_selection_csv)
    from convex_dim_red_tpu.pipelines.dataset import open_dataset

    pca_ds = open_dataset(pca)
    grid_shape = pca_ds['EOFs'].data.shape[1:]
    eof_grids = pca_ds['EOFs'].data.reshape(N_MODES, -1)
    missing = ~np.isfinite(eof_grids).all(axis=0)
    eofs_valid = eof_grids[:, ~missing]          # (modes, valid cells)
    print("EOF variance ratios:",
          np.round(pca_ds['explained_variance_ratio'].data, 3))

    # PC-space states -> grid patterns through the EOF basis.
    states = {
        'aa': open_dataset(aa)['archetypes'].data,          # (k, modes)
        'gpnh': open_dataset(gpnh)['dictionary'].data,      # (k, modes)
        'pc_kmeans': open_dataset(pc_km)['centroids'].data, # (k, modes)
    }
    grid_states = {name: s @ eofs_valid for name, s in states.items()}
    # The gridded k-means analyzed the same lat band with the same
    # weighting, so its (NaN-refilled) centroid grids share the mask.
    grid_states['grid_kmeans'] = open_dataset(grid_km)[
        'centroids'].data.reshape(K, -1)[:, ~missing]

    # Sort every method's states against the leading EOF patterns and
    # record the table (notebook analog of the state-ordering cell).
    ref_patterns = eofs_valid[:K]
    sort_rows = []
    for name, patterns in grid_states.items():
        order, signs, corr = sort_states(patterns, ref_patterns)
        best = corr[order, np.arange(K)] * signs
        print(f"{name:12s} state order vs EOFs: {order.tolist()} "
              f"signs {signs.tolist()} |corr| "
              f"{np.round(np.abs(best), 3).tolist()}")
        for eof_idx in range(K):
            sort_rows.append({
                'method': name, 'eof': eof_idx,
                'state': int(order[eof_idx]),
                'sign': int(signs[eof_idx]),
                'abs_corr': float(abs(best[eof_idx]))})
    sort_csv = os.path.join(args.out_dir, "state_sort.csv")
    with open(sort_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(sort_rows[0]))
        w.writeheader()
        w.writerows(sort_rows)
    print("wrote", sort_csv)

    # Cross-method correspondence: AA archetypes vs k-means centroids.
    cross = pattern_correlation(grid_states['aa'],
                                grid_states['grid_kmeans'])
    match = np.argmax(np.abs(cross), axis=1)
    print("AA archetype -> closest grid-kmeans centroid:",
          match.tolist(),
          "corr", np.round(np.abs(cross[np.arange(K), match]), 3).tolist())
    match_csv = os.path.join(args.out_dir, "cross_method_match.csv")
    with open(match_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=['aa_state',
                                          'grid_kmeans_centroid',
                                          'abs_corr'])
        w.writeheader()
        for i in range(K):
            w.writerow({'aa_state': i,
                        'grid_kmeans_centroid': int(match[i]),
                        'abs_corr': float(abs(cross[i, match[i]]))})
    print("wrote", match_csv)
    print("gap statistic (grid kmeans):",
          open_dataset(grid_km).attrs.get('gap_statistic'))

    # AA model-selection curve over k in PC space.
    import jax
    if args.platform:
        jax.config.update('jax_platforms', args.platform)
    from convex_dim_red_tpu.parallel.sweep import aa_model_selection_sweep
    pcs = pca_ds['PCs'].data.astype(np.float32)
    sweep = aa_model_selection_sweep(
        pcs, ks=[2, 3] if quick else [2, 3, 4, 5],
        key=jax.random.PRNGKey(0), n_init=4 if quick else 8,
        tolerance=1e-6, max_iterations=60 if quick else 200,
        init='random')
    csv_path = os.path.join(args.out_dir, "model_selection.csv")
    write_model_selection_csv(csv_path, sweep)
    print("wrote", csv_path)

    write_figures(args.out_dir, pca_ds, grid_states, grid_shape, missing)
    print("done; outputs in", args.out_dir)


def write_figures(out_dir, pca_ds, grid_states, grid_shape, missing):
    """Render the JRA-55 combined figure inventory: per-method
    grid-state maps (states refilled onto the lat/lon grid through the
    shared valid-cell mask), the EOF patterns, and the model-selection
    curves — the plots the stripped upstream notebook produced from the
    same driver outputs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from convex_dim_red_tpu.pipelines.plotting import (
        plot_model_selection, plot_patterns)

    lat_name = [d for d in pca_ds['EOFs'].dims if 'lat' in d][0]
    lon_name = [d for d in pca_ds['EOFs'].dims if 'lon' in d][0]
    lats = pca_ds.coords[lat_name].data
    lons = pca_ds.coords[lon_name].data

    def save(fig, name):
        path = os.path.join(out_dir, name)
        fig.savefig(path, dpi=110)
        plt.close(fig)
        print("wrote", path)

    for name, patterns in grid_states.items():
        k = patterns.shape[0]
        full = np.full((k, missing.size), np.nan, patterns.dtype)
        full[:, ~missing] = patterns
        fig = plot_patterns(
            full.reshape((k,) + tuple(grid_shape)), lats, lons,
            titles=[f"{name} state {i}" for i in range(k)])
        save(fig, f"jra55_{name}_grid_states.png")

    fig = plot_patterns(
        np.asarray(pca_ds['EOFs'].data), lats, lons,
        titles=[f"EOF {i}" for i in range(pca_ds['EOFs'].data.shape[0])])
    save(fig, "jra55_eof_patterns.png")

    with open(os.path.join(out_dir, "model_selection.csv")) as f:
        rows = list(csv.DictReader(f))
    results = {int(r['k']): {m: float(r[m]) for m in r if m != 'k'}
               for r in rows}
    fig = plot_model_selection(results, metrics=("cost", "rmse"))
    save(fig, "model_selection.png")


if __name__ == "__main__":
    main()
