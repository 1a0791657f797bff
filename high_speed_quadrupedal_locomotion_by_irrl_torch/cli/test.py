"""Deployment / evaluation entry point of the PyTorch port (run_bp_v5.py test branch).

  python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.test \
      --model artifacts/irrl_tpu_relaxed_4e8 --eval --commands 1,2,3,4,5 --steps 2000

  python -m high_speed_quadrupedal_locomotion_by_irrl_torch.cli.test \
      --model artifacts/irrl_tpu_relaxed_4e8 \
      --torque --wc --ss --corr --delay 0,1,2,5 --vx 2.0 --save-data runs/test

Port of the JAX package's ``cli/test.py``: every flag of it, each mapping to
one analysis mode of the reference driver (--eval tracking run_bp_v5.py:738-818,
--wc :916-1030, --torque :846-914, --ss :520-662, --delay latency sweep
:360-365, correlation heatmaps :1032-1088, --pca :820-844, --spectro
:1090-1117, --traces :664-736, --kappa / --kappa-entropy the Figure-4
robustness fits, --landscape the Figure-2 reward landscape, --teleop / --serve
the interactive loop with the RaisimServer twin, --viewer / --vid / --dump-info
a recorded rollout, --save-energy-data :446-511); results print as tables
and optionally dump .npy and ``results.json`` (--save-data, :481-511). The
controller is a bp5 CSV directory or a ``ckpt_*.pkl`` that the port's
``cli.train`` wrote. Rollouts run on the card (``--device cuda``, the
default) or on the CPU (``--device cpu``); the figures render on the host.
On a terrain config every command starts on the same stretch of the
heightmap, drawn from the config's seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from high_speed_quadrupedal_locomotion_by_irrl_torch import config as cfg_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch import device as dev_mod
from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import eval as ev
from high_speed_quadrupedal_locomotion_by_irrl_torch.envs import blackpanther as bp
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import io as mio
from high_speed_quadrupedal_locomotion_by_irrl_torch.models import lstm


def parse_args(argv):
    p = argparse.ArgumentParser(description="IRRL evaluation (PyTorch port)")
    p.add_argument("--model", type=str, required=True,
                   help="bp5 CSV directory or checkpoint .pkl of this port")
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--vx", type=float, default=1.0)
    p.add_argument("--commands", type=str, default="1,2,3,4,5")
    p.add_argument("--steps", type=int, default=750)
    p.add_argument("--eval", action="store_true", help="velocity tracking eval")
    p.add_argument("--wc", action="store_true", help="motor work-condition envelope")
    p.add_argument("--torque", action="store_true", help="torque/power + TCoT")
    p.add_argument("--ss", action="store_true", help="state-space portraits")
    p.add_argument("--corr", action="store_true", help="LSTM state correlation")
    p.add_argument("--pca", type=str, default=None, metavar="OUT.png",
                   help="hidden-state PCA map colored by value "
                        "(run_bp_v5.py:820-844)")
    p.add_argument("--spectro", type=str, default=None, metavar="OUT.png",
                   help="knee joint-velocity spectrogram "
                        "(run_bp_v5.py:1090-1117)")
    p.add_argument("--traces", type=str, default=None, metavar="PREFIX",
                   help="joint-trace + end-effector-trajectory figures "
                        "(PREFIX_joints.png / PREFIX_ee.png, "
                        "run_bp_v5.py:664-736)")
    p.add_argument("--delay", type=str, default=None,
                   help="comma-separated latency sweep in control steps")
    p.add_argument("--poincare", type=str, default=None, metavar="OUT.png",
                   help="first-return maps of v_x^B sampled once per gait "
                        "period, one panel per --delay value (Figure4 "
                        "plot_poincare; requires --delay)")
    p.add_argument("--save-data", type=str, default=None, help="npy dump dir")
    p.add_argument("--save-energy-data", type=str, default=None, metavar="DIR",
                   help="per-step energy/dynamics npy dump incl. M^-1 and "
                        "nonlinearities (run_bp_v5.py:446-511)")
    p.add_argument("--kappa", action="store_true",
                   help="disturbance-recovery rate fits (Figure4 robustness)")
    p.add_argument("--kick", type=float, default=1.0,
                   help="lateral velocity kick [m/s] for --kappa")
    p.add_argument("--kappa-entropy", action="store_true",
                   help="Figure4's own kappa estimator: ensemble-entropy "
                        "decay fits over --ensemble noise-spread episodes "
                        "per command (analysis.robustness.entropy_kappa)")
    p.add_argument("--ensemble", type=int, default=2048,
                   help="episodes per entropy ensemble (--kappa-entropy)")
    p.add_argument("--landscape", type=str, default=None, metavar="MODEL_B,MODEL_C",
                   help="reward-landscape sweep over the parameter simplex "
                        "spanned by --model and two more controllers; writes "
                        "total_reward.txt + ternary panels next to --save-data")
    p.add_argument("--landscape-step", type=float, default=0.05)
    p.add_argument("--teleop", action="store_true",
                   help="interactive teleop loop (gamepad if present, else "
                        "scripted schedule) — the reference's Manual test mode")
    p.add_argument("--serve", type=int, default=None, metavar="PORT",
                   help="stream OriginState snapshots on this TCP port "
                        "(RaisimServer twin; 0 = ephemeral)")
    p.add_argument("--realtime", action="store_true",
                   help="pace the teleop loop at control_dt wall time")
    p.add_argument("--viewer", type=str, default=None, metavar="OUT.html",
                   help="render a closed-loop rollout into a standalone "
                        "interactive 3D HTML viewer (OgreVis twin)")
    p.add_argument("--vid", type=str, default=None, metavar="OUT.gif",
                   help="record a rollout animation (the reference's --vid / "
                        "startRecordingVideo path, run_bp_v5.py:322-329)")
    p.add_argument("--dump-info", type=str, default=None, metavar="OUT.csv",
                   help="dump the rollout in the reference's info-CSV format "
                        "(consumable by Data_Visualization_Code/Figure2.py)")
    p.add_argument("--material", type=str, default=None, metavar="F,E,T",
                   help="contact material triple friction,restitution,"
                        "threshold applied before any mode runs — the "
                        "reference's test path calls SetContactCoefficient("
                        "[0.8,0.2,0.01]) before eval (run_bp_v5.py:317, "
                        "Environment.hpp:1407-1418)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def _load_params(path: str, device):
    if os.path.isdir(path):
        return mio.load_bp5_csv(path, device=device)
    return mio.load_checkpoint(path, device)[0]


def interactive(cfg, params, n_steps: int, serve_port=None, realtime=False,
                seed: int = 0, device=None):
    """Interactive closed-loop teleop (run_bp_v5.py test hot loop, :267-462):
    gamepad (or scripted) command -> LSTM policy -> env step at B = 1,
    optionally streaming state snapshots (origin_state + command, 44 floats)
    to remote viewers via the native StateServer."""
    from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import gamepad as gp
    from high_speed_quadrupedal_locomotion_by_irrl_torch.utils import native

    device = dev_mod.resolve(device)
    cfg = ev._fixed_command_cfg(cfg)
    pad = gp.open_pad(dt=cfg.control_dt)
    srv = native.StateServer(serve_port) if serve_port is not None else None
    if srv is not None:
        print(f"state server on 127.0.0.1:{srv.port}", flush=True)

    cmd_scale = np.array([cfg.vx_max, cfg.vy_max, cfg.omega_max])
    gen = torch.Generator(device=device).manual_seed(seed)
    state = bp.env_init(cfg, 1, gen, device)
    obs = bp.observe(cfg, state)
    env_step = ev.env_step(cfg)
    s_size = lstm.state_size([w.wh.shape[0] for w in params.pi_lstm])
    lstm_state = torch.zeros((1, s_size), device=device)
    no_reset = torch.zeros(1, device=device)
    mean, std = bp.obs_mean(cfg, device)[:3], bp.obs_std(cfg, device)[:3]
    v_hist = []
    t_next = time.perf_counter()
    try:
        for i in range(n_steps):
            command = dev_mod.tensor(np.clip(pad.poll(), -1, 1) * cmd_scale, device)[None]
            o = torch.cat([(command - mean) / std, obs[:, 3:]], dim=-1)
            action, lstm_state = lstm.deterministic_action(params, o, lstm_state, no_reset)
            out = env_step(cfg, state.replace(command=command, command_filtered=command),
                           action, gen)
            state, obs = out.state, out.obs
            snap = torch.cat([bp.origin_state(state)[0], command[0]]).cpu().numpy()
            if srv is not None:
                srv.update(snap)
            v_hist.append(snap[19:22])
            if realtime:
                t_next += cfg.control_dt
                dt = t_next - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)
            if i % 250 == 0:
                print(f"t={i * cfg.control_dt:6.2f}s cmd={command[0].cpu().numpy()} "
                      f"v={snap[19:22]}", flush=True)
    finally:
        pad.close()
        if srv is not None:
            srv.close()
    v = np.asarray(v_hist)
    return {"v_mean": v.mean(0).tolist(), "steps": len(v_hist)}


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    device = dev_mod.resolve(args.device)
    cfg = cfg_mod.from_yaml(args.cfg) if args.cfg else cfg_mod.test_default()
    if args.material is not None:
        f, e, t = (float(x) for x in args.material.split(","))
        cfg = cfg.replace(contact_friction=f, contact_restitution=e,
                          contact_res_threshold=t)
    else:
        print("cli.test: no --material given; running on the config's "
              f"default contact triple ({cfg.contact_friction}, "
              f"{cfg.contact_restitution}, {cfg.contact_res_threshold}). "
              "For reference test-path parity pass "
              "--material 0.8,0.2,0.01 (run_bp_v5.py:317)")
    params = _load_params(args.model, device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    results = {}
    vx_cmd = np.array([args.vx, 0.0, 0.0])

    if args.teleop or args.serve is not None:
        results["teleop"] = interactive(cfg, params, args.steps, serve_port=args.serve,
                                        realtime=args.realtime, seed=cfg.seed, device=device)
        print(f"teleop: {results['teleop']['steps']} steps, "
              f"mean v {results['teleop']['v_mean']}")
    if args.eval:
        cmds = [float(c) for c in args.commands.split(",")]
        results["tracking"] = ev.tracking_eval(cfg, params, cmds, gen, args.steps,
                                               device=device)
        for r in results["tracking"]:
            print(f"cmd {r['command']:.1f} m/s -> v {r['v_mean']:+.2f} "
                  f"(err {r['err_mean']:+.3f} +- {r['err_std']:.3f})")
    if args.torque:
        tp = ev.torque_power(cfg, params, args.vx, gen, args.steps, device=device)
        results["torque_power"] = {k: v for k, v in tp.items()
                                   if not isinstance(v, np.ndarray)}
        print(f"vx {args.vx}: mean power {tp['mean_power']:.1f} W, TCoT {tp['tcot']:.3f}")
    if args.wc:
        wc = ev.work_condition(cfg, params, args.vx, gen, args.steps, device=device)
        results["work_condition"] = {"violation_rate": wc["violation_rate"]}
        print(f"motor envelope violation rate: {wc['violation_rate']:.4f}")
    if args.ss:
        ss = ev.state_space(cfg, params, args.vx, gen, args.steps, device=device)
        results["state_space"] = {"q_range": [float(ss['q'].min()), float(ss['q'].max())]}
        print(f"state-space q range: {results['state_space']['q_range']}")
        if args.save_data:
            os.makedirs(args.save_data, exist_ok=True)
            np.save(os.path.join(args.save_data, "state_space_q.npy"), ss["q"])
            np.save(os.path.join(args.save_data, "state_space_qd.npy"), ss["qd"])
    if args.corr:
        corr = ev.lstm_state_correlation(cfg, params, args.vx, gen, args.steps, device=device)
        results["lstm_corr_mean_abs"] = float(np.abs(corr).mean())
        print(f"LSTM state |corr| mean: {results['lstm_corr_mean_abs']:.3f}")
    if args.pca or args.spectro or args.traces:
        from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import figures

        log = ev.policy_rollout(ev._fixed_command_cfg(cfg), params, vx_cmd, gen, args.steps,
                                device=device)
        if args.pca:
            res = ev.value_pca(params, log)
            figures.pca_value_figure(res, args.pca)
            results["pca"] = {"explained": [float(e) for e in res["explained"]]}
            print(f"value-PCA map -> {args.pca} "
                  f"(PC1+PC2 explain {res['explained'].sum():.0%})")
        if args.spectro:
            qd_knee = log.gv[:, 6 + 2].cpu().numpy()  # FR knee velocity
            spec = ev.spectrogram(qd_knee, cfg.control_dt)
            figures.spectrogram_figure(spec, args.spectro)
            results["spectro"] = args.spectro
            print(f"spectrogram -> {args.spectro}")
        if args.traces:
            figures.joint_traces_figure(ev.numpy_log(log), cfg.control_dt,
                                        args.traces + "_joints.png")
            figures.ee_traj_figure(ev.toe_trajectories(log), args.traces + "_ee.png")
            results["traces"] = args.traces
            print(f"joint/EE traces -> {args.traces}_joints.png, "
                  f"{args.traces}_ee.png")
    if args.kappa:
        from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import robustness as rb

        cmds = [float(c) for c in args.commands.split(",")]
        rows = rb.recovery_sweep(cfg, params, cmds, [args.kick], gen, device=device)
        results["recovery"] = rows
        for r in rows:
            print(f"cmd {r['command']:.1f} kick {r['kick']:.1f} m/s -> "
                  f"kappa {r['kappa']:+.2f} log_e/s (r2 {r['r2']:.2f}, "
                  f"{'survived' if r['survived'] else 'FELL'})")
    if args.kappa_entropy:
        from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import robustness as rb

        rows = []
        for c in (float(c) for c in args.commands.split(",")):
            fit = rb.entropy_kappa(cfg, params, np.array([c, 0.0, 0.0]), gen,
                                   n_episodes=args.ensemble, n_steps=args.steps,
                                   device=device)
            rows.append({"command": c, "kappa": fit["kappa"],
                         "kappa_err": fit["kappa_err"],
                         "v_mean": fit["v_mean"],
                         "survival": fit["survival"]})
            print(f"cmd {c:.1f}: entropy-kappa {fit['kappa']:+.2f} "
                  f"+- {fit['kappa_err']:.2f} log_e/s  v {fit['v_mean']:+.2f} "
                  f"survival {fit['survival']:.3f}")
        results["entropy_kappa"] = rows
    if args.landscape:
        from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import figures
        from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import landscape as ls

        others = [_load_params(p, device) for p in args.landscape.split(",")]
        res = ls.reward_landscape(cfg, params, others[0], others[1], vx_cmd,
                                  step=args.landscape_step, gen=gen, device=device)
        out_dir = args.save_data or "."
        os.makedirs(out_dir, exist_ok=True)
        ls.save_total_reward(os.path.join(out_dir, "total_reward.txt"), cfg, res)
        comps = ls.composites(cfg, res["terms"])
        figures.ternary_landscape_figure(
            res, comps, os.path.join(out_dir, "reward_landscape.png"))
        results["landscape_points"] = len(res["w"])
        print(f"landscape: {len(res['w'])} blends -> "
              f"{out_dir}/total_reward.txt + reward_landscape.png")
    if args.delay:
        delays = [int(d) for d in args.delay.split(",")]
        results["latency"] = ev.latency_sweep(cfg, params, args.vx, delays, gen, args.steps,
                                              device=device)
        for r in results["latency"]:
            print(f"latency {r['latency_ms']:.1f} ms -> v {r['v_mean']:+.2f} "
                  f"(survival {r['survival']:.2f})")
        if args.poincare:
            from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import figures

            sign = -1.0 if cfg.wildcat else 1.0
            period_steps = max(int(round(cfg.period / cfg.control_dt)), 1)
            series = {}
            for d in delays:
                log = ev.policy_rollout(ev._fixed_command_cfg(cfg), params, vx_cmd, gen,
                                        args.steps, delay_steps=int(d), device=device)
                vx = sign * ev.body_velocity(log)[:, 0]
                sel = np.arange(period_steps // 2, len(vx), period_steps)
                series[f"{d * cfg.control_dt * 1e3:.0f} ms"] = vx[sel]
            figures.poincare_figure(series, args.poincare,
                                    xlabel="$v_{x,n}^B$",
                                    ylabel="$v_{x,n+1}^B$")
            results["poincare"] = args.poincare
            print(f"poincare maps -> {args.poincare}")
    if args.viewer or args.vid or args.dump_info:
        log = ev.numpy_log(ev.policy_rollout(ev._fixed_command_cfg(cfg), params, vx_cmd, gen,
                                             args.steps, device=device))
        if args.viewer:
            from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import viewer
            viewer.write_html(cfg, log, args.viewer)
            results["viewer"] = args.viewer
            print(f"viewer written to {args.viewer}")
        if args.vid:
            from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import figures
            figures.rollout_animation(log, args.vid)
            results["vid"] = args.vid
            print(f"animation written to {args.vid}")
        if args.dump_info:
            from high_speed_quadrupedal_locomotion_by_irrl_torch.analysis import rawdata
            rawdata.dump_robot_info(args.dump_info, log.gc, log.gv, log.torque, log.contact)
            results["dump_info"] = args.dump_info
            print(f"info CSV written to {args.dump_info}")
    if args.save_energy_data:
        ed = ev.energy_data(cfg, params, args.vx, gen, args.steps, device=device)
        os.makedirs(args.save_energy_data, exist_ok=True)
        for name, arr in ed.items():
            np.save(os.path.join(args.save_energy_data, f"{name}.npy"), arr)
        results["energy_data"] = sorted(ed)
        print(f"energy dump ({', '.join(sorted(ed))}) -> {args.save_energy_data}")
    if args.save_data:
        os.makedirs(args.save_data, exist_ok=True)
        with open(os.path.join(args.save_data, "results.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
