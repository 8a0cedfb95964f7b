"""HTML templates for the web tier, generated server-side (the port's
copy of the JAX package's ``serve/templates.py``, the same pages and
fetch protocol, naming the CUDA device).

Functional re-design of the reference's Jinja templates
(``templates/index.html`` / ``metrics.html`` / ``documentation.html``):
the same three pages, the same fetch endpoints and polling protocol
(upload -> /upload; training panel -> /start_training, /training_progress
every 2s, /stop_training; /generate_synthetic_data), written compactly
from scratch.
"""

_BASE_CSS = """
body{font-family:system-ui,sans-serif;margin:0;background:#f4f6f8;color:#222}
header{background:#1f2a38;color:#fff;padding:14px 28px}
header a{color:#9ecbff;margin-right:18px;text-decoration:none}
main{max-width:1000px;margin:24px auto;padding:0 16px}
.card{background:#fff;border-radius:10px;padding:20px;margin-bottom:18px;
box-shadow:0 1px 4px rgba(0,0,0,.08)}
button{background:#2d7ff9;color:#fff;border:0;border-radius:6px;
padding:9px 18px;cursor:pointer;font-size:14px}
button.stop{background:#d9534f}
input,select{padding:6px;margin:4px 0;border:1px solid #ccc;border-radius:5px}
pre{background:#0f1720;color:#c9e3ff;padding:12px;border-radius:8px;
overflow:auto;max-height:260px}
table{border-collapse:collapse}td,th{border:1px solid #ddd;padding:6px 10px}
.metric{font-size:26px;font-weight:700;color:#2d7ff9}
img.viz{max-width:100%;border-radius:8px;margin-top:10px}
"""

_HEADER = """
<header><b>Brain Tumor Segmentation &amp; Classification — GPU</b>
 &nbsp;&nbsp;<a href="/">Analyze</a><a href="/metrics">Metrics</a>
<a href="/documentation">Documentation</a></header>
"""


def index_page() -> str:
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Brain Tumor Analysis (GPU)</title><style>{_BASE_CSS}
#drop{{border:2px dashed #9bb3cc;border-radius:10px;padding:26px;
text-align:center;color:#567;transition:background .15s}}
#drop.hover{{background:#e8f1fd;border-color:#2d7ff9}}
.bar{{height:8px;background:#e3e9f0;border-radius:4px;overflow:hidden;
margin:8px 0}}.bar>div{{height:100%;width:0;background:#2d7ff9;
transition:width .4s}}
.badge{{display:inline-block;background:#f0ad4e;color:#fff;
border-radius:4px;padding:2px 8px;font-size:12px;margin-left:8px}}
.cards{{display:flex;flex-wrap:wrap;gap:10px;margin:12px 0}}
.mcard{{flex:1 1 140px;background:#f0f5fb;border-radius:8px;
padding:10px 14px;text-align:center}}
.mcard .v{{font-size:20px;font-weight:700;color:#1f2a38}}
.mcard .l{{font-size:12px;color:#678}}
.tabs{{display:flex;gap:4px;margin:14px 0 0}}
.tabs button{{background:#e3e9f0;color:#345;border-radius:6px 6px 0 0}}
.tabs button.on{{background:#2d7ff9;color:#fff}}
.tabpane{{display:none;border:1px solid #e3e9f0;border-radius:0 8px 8px 8px;
padding:12px}}.tabpane.on{{display:block}}
iframe.v3d{{width:100%;height:480px;border:0;border-radius:8px}}
</style></head>
<body>{_HEADER}<main>

<div class="card"><h2>Upload MRI scan</h2>
<p>NIfTI (.nii/.nii.gz), NumPy (.npy) or 2D image. Runs real GPU
inference: 3D U-Net segmentation + tumor-grade classification.</p>
<div id="drop">Drag &amp; drop a scan here, or
  <label style="color:#2d7ff9;cursor:pointer"><u>browse</u>
  <input type="file" id="file" style="display:none"></label>
  <div id="fname" style="margin-top:6px;font-weight:600"></div></div>
<label><input type="checkbox" id="demo"> demo mode (synthetic)</label>
<label><input type="checkbox" id="wantmask"> return mask
(.nii.gz download)</label>
<button onclick="upload()">Analyze</button>
<div class="bar"><div id="pbar"></div></div>
<div id="status"></div><div id="results"></div></div>

<div class="card"><h2>Training manager</h2>
Epochs <input id="epochs" type="number" value="5" style="width:70px">
Batch <input id="batch" type="number" value="2" style="width:60px">
LR <input id="lr" value="0.0001" style="width:90px">
Samples <input id="nsamp" type="number" value="8" style="width:70px">
Arch <select id="arch"><option value="attention_unet">Attention U-Net
</option><option value="attention_unet_full">Full (32..512)</option>
<option value="unet3d">3D U-Net with Attention</option>
<option value="lightweight">Lightweight U-Net</option>
<option value="enhanced">Enhanced U-Net</option>
<option value="joint">Joint seg+grade</option>
</select>
Mode <select id="mode"><option value="real">real</option>
<option value="demo">demo</option></select>
<button onclick="startTraining()">Start</button>
<button class="stop" onclick="stopTraining()">Stop</button>
<button onclick="genData()">Generate synthetic data</button>
<div id="tstatus"></div><pre id="tlogs"></pre></div>

<script>
let sessionId = null, poller = null, dropFile = null;
let diceHist = [];
let lastDiceEpoch = -1;

// drag & drop upload zone
const drop = document.getElementById('drop');
drop.addEventListener('dragover', e => {{
  e.preventDefault(); drop.classList.add('hover'); }});
drop.addEventListener('dragleave', () => drop.classList.remove('hover'));
drop.addEventListener('drop', e => {{
  e.preventDefault(); drop.classList.remove('hover');
  if (e.dataTransfer.files.length) setFile(e.dataTransfer.files[0]);
}});
document.getElementById('file').addEventListener('change', e => {{
  if (e.target.files.length) setFile(e.target.files[0]); }});
function setFile(f) {{
  dropFile = f;
  document.getElementById('fname').textContent =
      f.name + ' (' + (f.size / 1048576).toFixed(1) + ' MB)';
}}

// staged narration while the request is in flight
const STAGES = [
  [8,  'Uploading scan...'],
  [25, 'Decoding volume and normalizing intensities...'],
  [45, 'Cropping to brain extent...'],
  [70, 'Running 3D U-Net sliding-window segmentation on GPU...'],
  [88, 'Classifying tumor grade and compiling clinical report...']];
let stageTimer = null;
function narrate(on) {{
  const bar = document.getElementById('pbar'),
        st = document.getElementById('status');
  if (!on) {{ clearInterval(stageTimer); bar.style.width = '100%';
              return; }}
  let i = 0; bar.style.width = '4%';
  st.textContent = STAGES[0][1];
  stageTimer = setInterval(() => {{
    if (i < STAGES.length) {{
      bar.style.width = STAGES[i][0] + '%';
      st.textContent = STAGES[i][1]; i++;
    }}
  }}, 900);
}}

// client-side demo fallback when the server is unreachable/degraded —
// clearly labeled, mirrors the reference UI's offline demo behavior
function demoAnalysis() {{
  return {{success: true, demo_fallback: true,
    classification: {{primary_diagnosis: 'Glioma (demo)',
      confidence: 0.87, risk_level: 'moderate'}},
    measurements: {{tumor_volume: '12.4 cm³ (demo)',
      tumor_percentage: '0.9% (demo)',
      equivalent_diameter: '28.7 mm (demo)',
      surface_area: '2340 mm² (demo)'}},
    quality_metrics: {{dice_coefficient: '— (demo)',
      hausdorff_distance: '— (demo)'}},
    clinical_notes: {{
      findings: ['Demo analysis generated in the browser: the server ' +
                 'was unreachable, no inference was run.'],
      recommendations: ['Start the GPU service and re-upload the scan ' +
                        'for a real analysis.']}},
    visualizations: {{multiplanar: '', analysis: ''}}}};
}}

async function upload() {{
  const f = dropFile || document.getElementById('file').files[0];
  const demo = document.getElementById('demo').checked;
  const fd = new FormData();
  if (f) fd.append('file', f);
  fd.append('demo', demo ? '1' : '0');
  // opt-in: a full-res mask is a large base64 payload
  if (document.getElementById('wantmask').checked && !demo)
    fd.append('return_mask', '1');
  narrate(true);
  let j;
  try {{
    const r = await fetch('/upload', {{method: 'POST', body: fd}});
    j = await r.json();
  }} catch (e) {{
    j = demoAnalysis();
  }}
  narrate(false);
  document.getElementById('status').innerHTML =
      (j.success ? 'Done' : ('Error: ' + j.error)) +
      (j.demo_fallback ?
       ' <span class="badge">offline demo — not real inference</span>'
       : '');
  if (!j.success) return;
  let maskLink = '';
  if (j.mask_nifti_base64) {{
    maskLink = `<p><a download="segmentation.nii.gz"
      href="data:application/gzip;base64,${{j.mask_nifti_base64}}">
      Download segmentation mask (.nii.gz, ${{j.mask_grid}} grid)</a></p>`;
  }}
  renderResults(j, maskLink);
}}
// metric cards + tabbed visualization panes (Summary / MPR / Analysis /
// 3D viewer) — the richer results layout of the reference UI
// (templates/index.html:700-940), rebuilt compactly
function card(label, value) {{
  return `<div class="mcard"><div class="v">${{value}}</div>
          <div class="l">${{label}}</div></div>`;
}}
function showTab(i) {{
  document.querySelectorAll('.tabs button').forEach((b, k) =>
      b.classList.toggle('on', k === i));
  document.querySelectorAll('.tabpane').forEach((p, k) =>
      p.classList.toggle('on', k === i));
}}
function renderResults(j, maskLink) {{
  const el = document.getElementById('results');
  const viz = j.visualizations || {{}};
  const tabs = ['Summary'];
  const panes = [`
    <table>
    <tr><th>Tumor volume</th><td>${{j.measurements.tumor_volume}}</td></tr>
    <tr><th>% of brain</th><td>${{j.measurements.tumor_percentage}}</td></tr>
    <tr><th>Equivalent diameter</th>
        <td>${{j.measurements.equivalent_diameter}}</td></tr>
    <tr><th>Surface area</th><td>${{j.measurements.surface_area}}</td></tr>
    <tr><th>Dice</th><td>${{j.quality_metrics.dice_coefficient}}</td></tr>
    <tr><th>HD</th><td>${{j.quality_metrics.hausdorff_distance}}</td></tr>
    </table>
    <h4>Findings</h4><ul>${{
      j.clinical_notes.findings.map(x=>'<li>'+x+'</li>').join('')}}</ul>
    <h4>Recommendations</h4><ul>${{
      j.clinical_notes.recommendations.map(x=>'<li>'+x+'</li>').join('')
    }}</ul>`];
  if (viz.multiplanar) {{
    tabs.push('Multiplanar');
    panes.push(`<img class="viz" src="${{viz.multiplanar}}">`);
  }}
  if (viz.analysis) {{
    tabs.push('Analysis');
    panes.push(`<img class="viz" src="${{viz.analysis}}">`);
  }}
  if (viz.visualization_3d) {{
    tabs.push('3D viewer');
    panes.push('<iframe class="v3d" id="v3dframe"></iframe>');
  }}
  el.innerHTML = maskLink + `
    <h3>${{j.classification.primary_diagnosis}}</h3>
    <div class="cards">
      ${{card('confidence',
              (j.classification.confidence*100).toFixed(1) + '%')}}
      ${{card('risk level', j.classification.risk_level)}}
      ${{card('tumor volume', j.measurements.tumor_volume)}}
      ${{card('dice', j.quality_metrics.dice_coefficient)}}
    </div>
    <div class="tabs">${{tabs.map((t, i) =>
      `<button onclick="showTab(${{i}})">${{t}}</button>`).join('')}}</div>
    ${{panes.map(p => `<div class="tabpane">${{p}}</div>`).join('')}}`;
  if (viz.visualization_3d) {{
    // srcdoc via property (the plotly document is a full HTML page)
    document.getElementById('v3dframe').srcdoc = viz.visualization_3d;
  }}
  showTab(0);
}}
async function startTraining() {{
  diceHist = [];        // fresh sparkline per session
  lastDiceEpoch = -1;
  const cfg = {{
    epochs: +document.getElementById('epochs').value,
    batch_size: +document.getElementById('batch').value,
    learning_rate: +document.getElementById('lr').value,
    num_samples: +document.getElementById('nsamp').value,
    model_arch: document.getElementById('arch').value,
    mode: document.getElementById('mode').value,
    data_type: 'synthetic'
  }};
  let j;
  try {{
    const r = await fetch('/start_training', {{method:'POST',
      headers: {{'Content-Type':'application/json'}},
      body: JSON.stringify(cfg)}});
    j = await r.json();
  }} catch (e) {{
    // server unreachable: run a clearly-labeled in-browser simulation
    // (mirrors the reference UI's offline simulateTraining fallback,
    // templates/index.html:1447-1492 — no real training happens)
    simulateTraining(cfg.epochs);
    return;
  }}
  if (!j.success) {{
    document.getElementById('tstatus').textContent = 'Error: ' + j.error;
    return;
  }}
  sessionId = j.session_id;
  document.getElementById('tstatus').textContent =
      'Session ' + sessionId + ' started';
  if (poller) clearInterval(poller);
  poller = setInterval(pollProgress, 2000);
}}
let simTimer = null;
function simulateTraining(epochs) {{
  sessionId = null;
  if (poller) clearInterval(poller);
  if (simTimer) clearInterval(simTimer);
  let ep = 0;
  const logs = ['[offline demo] server unreachable - simulating ' +
                epochs + ' epochs in the browser; NO real training'];
  simTimer = setInterval(() => {{
    ep++;
    const dice = Math.min(0.95, 0.30 + 0.012 * ep +
                          (Math.random() - 0.5) * 0.02);
    const loss = Math.max(0.05, 1.2 * Math.exp(-0.05 * ep) +
                          (Math.random() - 0.5) * 0.04);
    diceHist.push(dice);
    logs.push(`[offline demo] epoch ${{ep}}/${{epochs}} ` +
              `loss ${{loss.toFixed(4)}} dice ${{dice.toFixed(4)}}`);
    document.getElementById('tstatus').innerHTML =
      `status <b>simulated</b>` +
      ` <span class="badge">offline demo — not real training</span>` +
      ` — epoch ${{ep}}/${{epochs}} — loss ${{loss.toFixed(4)}}` +
      ` — dice ${{dice.toFixed(4)}}<br>` + sparkline(diceHist);
    document.getElementById('tlogs').textContent =
        logs.slice(-10).join('\\n');
    if (ep >= epochs) clearInterval(simTimer);
  }}, 1000);
}}
function sparkline(vals) {{
  if (vals.length < 2) return '';
  const w = 220, h = 36, mx = Math.max(...vals, 1e-9);
  const pts = vals.map((v, i) =>
      `${{(i / (vals.length - 1) * w).toFixed(1)}},` +
      `${{(h - v / mx * (h - 4) - 2).toFixed(1)}}`).join(' ');
  return `<svg width="${{w}}" height="${{h}}"><polyline points="${{pts}}"
      fill="none" stroke="#2d7ff9" stroke-width="2"/></svg>`;
}}
async function pollProgress() {{
  if (!sessionId) return;
  const r = await fetch('/training_progress?session_id=' + sessionId);
  const p = await r.json();
  // one point per completed EPOCH (the 2s poll would otherwise plot
  // poll count), reset per session in startTraining
  if (typeof p.dice_score === 'number' &&
      p.current_epoch > lastDiceEpoch) {{
    diceHist.push(p.dice_score);
    lastDiceEpoch = p.current_epoch;
  }}
  document.getElementById('tstatus').innerHTML =
    `status <b>${{p.status}}</b> — epoch ${{p.current_epoch}}/` +
    `${{p.total_epochs}} — loss ${{p.train_loss}} — dice ` +
    `${{p.dice_score}} (best ${{p.best_dice}})<br>` + sparkline(diceHist);
  document.getElementById('tlogs').textContent =
      (p.logs || []).join('\\n');
  if (['completed','error','stopped'].includes(p.status))
      clearInterval(poller);
}}
async function stopTraining() {{
  if (simTimer) {{ clearInterval(simTimer);
    document.getElementById('tstatus').innerHTML +=
        ' — simulation stopped'; }}
  if (!sessionId) return;
  await fetch('/stop_training', {{method:'POST',
    headers: {{'Content-Type':'application/json'}},
    body: JSON.stringify({{session_id: sessionId}})}});
}}
async function genData() {{
  const r = await fetch('/generate_synthetic_data', {{method:'POST',
    headers: {{'Content-Type':'application/json'}},
    body: JSON.stringify({{num_samples:
        +document.getElementById('nsamp').value}})}});
  const j = await r.json();
  document.getElementById('tstatus').textContent = j.message || j.error;
}}
</script></main></body></html>"""


def metrics_page(model_info=None) -> str:
    info = model_info or {}
    rows = "".join(f"<tr><th>{k}</th><td>{v}</td></tr>"
                   for k, v in info.items())
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Model Metrics</title><style>{_BASE_CSS}</style></head>
<body>{_HEADER}<main>
<div class="card"><h2>Segmentation performance (reference claims)</h2>
<p>Dice <span class="metric">0.892</span> &nbsp;
IoU <span class="metric">0.845</span></p>
<p>Published figures of the upstream pipeline
(reference templates/metrics.html); this deployment reports live
metrics per analysis and per training session.</p></div>
<div class="card"><h2>Classification performance (reference claims)</h2>
<p>Accuracy <span class="metric">94.2%</span>
Precision <span class="metric">91.8%</span>
Recall <span class="metric">93.5%</span></p></div>
<div class="card"><h2>Deployment</h2><table>{rows}</table></div>
</main></body></html>"""


def documentation_page() -> str:
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>Documentation</title><style>{_BASE_CSS}</style></head>
<body>{_HEADER}<main><div class="card">
<h2>API</h2>
<table>
<tr><th>POST /upload</th><td>multipart file -> JSON analysis
(classification, measurements, quality metrics, clinical notes,
visualizations; optional field return_mask=1 adds the predicted label
map as base64 .nii.gz with the scan's affine)</td></tr>
<tr><th>POST /start_training, GET /training_progress,
POST /stop_training</th><td>not served yet by this port (404)</td></tr>
<tr><th>POST /generate_synthetic_data</th><td>JSON {{num_samples}} ->
writes a BraTS-layout synthetic cohort</td></tr>
<tr><th>GET /health</th><td>device + model status</td></tr>
</table>
<h2>Stack</h2>
<p>PyTorch on an NVIDIA GPU, with hand-written CUDA kernels for the
level-0 and level-1 regions of the attention-gated residual 3D U-Net
(bf16, NDHWC) with deep supervision; foreground-cropped Gaussian
sliding-window inference at the scan's native resolution.</p>
<p>Research use only — not a medical device.</p>
</div></main></body></html>"""
