"""Flow-lite — a single-page operations UI served at `/` (the h2o-web /
Flow notebook analog, reduced to its operational core: cluster status,
frames, models with metrics, jobs, a model-build form and a Rapids
console, all driven by the same public REST routes a browser user of the
reference exercises through Flow)."""

FLOW_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>h2o3-tpu-torch Flow</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f4f6f8;color:#1d2733}
 header{background:#123b57;color:#fff;padding:10px 18px;font-size:18px}
 main{display:grid;grid-template-columns:1fr 1fr;gap:14px;padding:14px}
 section{background:#fff;border-radius:8px;padding:12px 14px;box-shadow:0 1px 3px rgba(0,0,0,.12)}
 h2{font-size:14px;margin:0 0 8px;color:#345}
 table{width:100%;border-collapse:collapse;font-size:12px}
 td,th{padding:3px 6px;border-bottom:1px solid #e5e9ee;text-align:left}
 input,select,button,textarea{font:inherit;padding:4px 6px;margin:2px}
 button{background:#1b6ca8;color:#fff;border:0;border-radius:4px;cursor:pointer}
 pre{background:#0e1726;color:#d7e3f4;padding:8px;border-radius:6px;font-size:11px;overflow:auto;max-height:180px}
 .full{grid-column:1/3}
</style></head><body>
<header>h2o3-tpu-torch &mdash; Flow <span id="cloud" style="font-size:12px"></span></header>
<main>
 <section><h2>Frames</h2><table id="frames"></table></section>
 <section><h2>Models</h2><table id="models"></table></section>
 <section><h2>Jobs</h2><table id="jobs"></table></section>
 <section><h2>Build model</h2>
  <select id="algo"></select>
  <input id="tf" placeholder="training_frame key">
  <input id="y" placeholder="response column">
  <input id="extra" placeholder="extra params k=v&k=v">
  <button onclick="build()">Build</button>
  <pre id="buildout"></pre></section>
 <section class="full"><h2>Rapids console</h2>
  <textarea id="ast" rows="2" style="width:90%">(+ 1 2)</textarea>
  <button onclick="rapids()">Run</button>
  <pre id="rapout"></pre></section>
</main>
<script>
const J = async (p, o) => (await fetch(p, o)).json();
function fillTable(id, head, rows){
  // textContent-only cells: registry names are data, never markup
  const t = document.getElementById(id); t.textContent='';
  const hr = t.insertRow();
  head.forEach(h=>{const th=document.createElement('th');th.textContent=h;hr.appendChild(th);});
  rows.forEach(r=>{const tr=t.insertRow();
    r.forEach(v=>{tr.insertCell().textContent=String(v);});});
}
async function refresh(){
  const c = await J('/3/Cloud');
  document.getElementById('cloud').textContent =
    ` ${c.cloud_name} · ${c.cloud_size} shards · v${c.version}`;
  const fr = await J('/3/Frames');
  fillTable('frames', ['key','rows','cols'],
    fr.frames.map(f=>[f.frame_id.name, f.rows, f.column_count]));
  const ms = await J('/3/Models');
  fillTable('models', ['model','algo','metric'],
    ms.models.map(m=>{const t=m.training_metrics||{};
      const met = t.auc!=null?('auc '+(+t.auc).toFixed(4)):(t.rmse!=null?('rmse '+(+t.rmse).toFixed(4)):'');
      return [m.model_id, m.algo, met]}));
  const js = await J('/3/Jobs');
  fillTable('jobs', ['job','status','progress'],
    js.jobs.slice(-12).reverse().map(j=>[j.description, j.status,
      Math.round(100*j.progress)+'%']));
}
async function loadAlgos(){
  const b = await J('/3/ModelBuilders');
  document.getElementById('algo').innerHTML =
    Object.keys(b.model_builders).map(a=>`<option>${a}</option>`).join('');
}
async function build(){
  const p = new URLSearchParams();
  p.set('training_frame', document.getElementById('tf').value);
  const y = document.getElementById('y').value;
  if (y) p.set('response_column', y);
  for (const kv of document.getElementById('extra').value.split('&'))
    if (kv.includes('=')) p.set(...kv.split('='));
  const algo = document.getElementById('algo').value;
  const r = await J('/3/ModelBuilders/'+algo, {method:'POST', body:p});
  document.getElementById('buildout').textContent = JSON.stringify(r, null, 1);
  setTimeout(refresh, 1200);
}
async function rapids(){
  const p = new URLSearchParams();
  p.set('ast', document.getElementById('ast').value);
  const r = await J('/99/Rapids', {method:'POST', body:p});
  document.getElementById('rapout').textContent = JSON.stringify(r, null, 1);
  refresh();
}
loadAlgos(); refresh(); setInterval(refresh, 5000);
</script></body></html>
"""


def _send_html(h, body: bytes):
    h.send_response(200)
    h.send_header("Content-Type", "text/html; charset=utf-8")
    h.send_header("Content-Length", str(len(body)))
    h.end_headers()
    if getattr(h, "command", "") != "HEAD":      # RFC 9110: no body
        h.wfile.write(body)


def h_flow(h):
    _send_html(h, FLOW_HTML.encode())


# ---------------------------------------------------------------------------
# Flow notebook (the h2o-web Flow cell model): an ordered list of cells —
# markdown | rapids | import | build | predict — executed top-to-bottom
# against the same REST surface, persisted as named documents through
# /3/NodePersistentStorage/notebooks/<name> (exactly where the reference
# Flow keeps its .flow documents).
NOTEBOOK_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>h2o3-tpu-torch Flow notebook</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#f4f6f8;color:#1d2733}
 header{background:#123b57;color:#fff;padding:10px 18px;font-size:18px;display:flex;gap:10px;align-items:center;flex-wrap:wrap}
 header input{font:inherit;padding:3px 6px;border-radius:4px;border:0}
 header a{color:#9fc3dd;font-size:12px}
 #layout{display:grid;grid-template-columns:230px 1fr;gap:12px;max-width:1280px;margin:14px auto;padding:0 10px}
 #side{display:flex;flex-direction:column;gap:10px}
 .pane{background:#fff;border-radius:8px;box-shadow:0 1px 3px rgba(0,0,0,.12);padding:8px 10px;font-size:12px}
 .pane h3{margin:0 0 6px;font-size:12px;color:#345}
 .pane div.item{padding:2px 4px;border-radius:3px;cursor:pointer;white-space:nowrap;overflow:hidden;text-overflow:ellipsis}
 .pane div.item:hover{background:#e8f0f6}
 #cells{display:flex;flex-direction:column;gap:10px}
 .cell{background:#fff;border-radius:8px;box-shadow:0 1px 3px rgba(0,0,0,.12);padding:10px 12px}
 .cell .bar{display:flex;gap:6px;align-items:center;font-size:11px;color:#678}
 .cell textarea{width:100%;font:12px/1.4 ui-monospace,monospace;border:1px solid #dde;border-radius:4px;margin-top:6px;padding:6px;box-sizing:border-box}
 .cell pre{background:#0e1726;color:#d7e3f4;padding:8px;border-radius:6px;font-size:11px;overflow:auto;max-height:220px;margin:6px 0 0}
 .cell .md{padding:4px 2px}
 .cell svg{margin-top:6px;background:#fff}
 button{background:#1b6ca8;color:#fff;border:0;border-radius:4px;cursor:pointer;font-size:12px;padding:3px 8px}
 button.ghost{background:#e4ecf2;color:#246}
 select{font-size:12px}
</style></head><body>
<header>h2o3-tpu-torch &mdash; Flow notebook
 <input id="nbname" value="notebook1" size="12">
 <button onclick="saveNb()">Save</button>
 <button onclick="loadNb()">Load</button>
 <button class="ghost" onclick="runAll()">Run all</button>
 <select id="assist" onchange="assist(this.value)">
  <option value="">Assist...</option>
  <option value="importFiles">importFiles</option>
  <option value="getFrames">getFrames</option>
  <option value="buildModel">buildModel</option>
  <option value="predict">predict</option>
  <option value="pipeline">parse &rarr; train &rarr; predict</option>
 </select>
 <button class="ghost" onclick="exportFlow()">Export .flow</button>
 <label class="ghost" style="background:#e4ecf2;color:#246;border-radius:4px;padding:3px 8px;font-size:12px;cursor:pointer">
  Import .flow<input id="flowfile" type="file" accept=".flow,.json" style="display:none" onchange="importFlow(this.files[0])"></label>
 <span id="status" style="font-size:12px"></span>
 <a href="/">ops dashboard</a>
</header>
<div id="layout">
<div id="side">
 <div class="pane"><h3>Frames</h3><div id="framelist"></div></div>
 <div class="pane"><h3>Models</h3><div id="modellist"></div></div>
</div>
<div>
<div id="cells"></div>
<div style="text-align:center;margin:12px">
 <select id="newtype"><option>rapids</option><option>markdown</option>
  <option>import</option><option>build</option><option>predict</option>
  <option>inspect</option></select>
 <button onclick="addCell()">+ cell</button>
</div>
</div>
</div>
<script>
const J = async (p, o) => (await fetch(p, o)).json();
let cells = [
 {type:'markdown', src:'# New Flow\\nCells run top-to-bottom against the cloud.'},
 {type:'rapids', src:'(+ 1 2)'}];
const PLACEHOLDER = {
 rapids:'(rapids expression)',
 markdown:'# heading\\ntext',
 import:'source_frames=/data/train.csv&destination_frame=train',
 build:'algo=gbm&training_frame=train&response_column=y&ntrees=20',
 predict:'model=gbm_1&frame=train&predictions_frame=preds',
 inspect:'frame-or-model key'};
function render(){
 const host = document.getElementById('cells');
 host.innerHTML='';
 cells.forEach((c,i)=>{
  const d = document.createElement('div'); d.className='cell';
  const md = c.type==='markdown';
  d.innerHTML = `<div class="bar"><b>[${i}] ${c.type}</b>
    <button onclick="runCell(${i})">Run</button>
    <button class="ghost" onclick="moveCell(${i},-1)">&uarr;</button>
    <button class="ghost" onclick="moveCell(${i},1)">&darr;</button>
    <button class="ghost" onclick="delCell(${i})">&times;</button></div>` +
   (md ? `<div class="md" id="md${i}"></div>` : '') +
   `<textarea id="src${i}" rows="${md?3:2}"
      placeholder="${PLACEHOLDER[c.type]||''}"
      oninput="cells[${i}].src=this.value${md?';mdRender('+i+')':''}"></textarea>` +
   `<div id="viz${i}"></div><pre id="out${i}" style="display:none"></pre>`;
  host.appendChild(d);
  document.getElementById('src'+i).value = c.src || '';
  if (md) mdRender(i);
 });
}
function mdRender(i){
 const src = cells[i].src || '';
 const esc = src.replace(/&/g,'&amp;').replace(/</g,'&lt;');
 document.getElementById('md'+i).innerHTML = esc
  .replace(/^### (.*)$/gm,'<h3>$1</h3>').replace(/^## (.*)$/gm,'<h2>$1</h2>')
  .replace(/^# (.*)$/gm,'<h1>$1</h1>')
  .replace(/\\*\\*([^*]+)\\*\\*/g,'<b>$1</b>').replace(/`([^`]+)`/g,'<code>$1</code>')
  .replace(/\\n/g,'<br>');
}
function addCell(t, src){
 cells.push({type: t || document.getElementById('newtype').value, src: src || ''});
 render();
}
function delCell(i){cells.splice(i,1); render();}
function moveCell(i,d){const j=i+d; if(j<0||j>=cells.length)return;
 [cells[i],cells[j]]=[cells[j],cells[i]]; render();}

// ---- assist: generate pre-filled cells from live cluster state --------
async function assist(kind){
 document.getElementById('assist').value='';
 if(!kind) return;
 const fr = (await J('/3/Frames')).frames.map(f=>f.frame_id.name);
 const ms = (await J('/3/Models')).models.map(m=>m.model_id);
 const f0 = fr[0]||'train', m0 = ms[0]||'model1';
 if(kind==='importFiles') addCell('import','source_frames=/path/to.csv&destination_frame=train');
 else if(kind==='getFrames') addCell('rapids',`(nrow ${f0})`);
 else if(kind==='buildModel') addCell('build',`algo=gbm&training_frame=${f0}&response_column=y&ntrees=20`);
 else if(kind==='predict') addCell('predict',`model=${m0}&frame=${f0}&predictions_frame=preds`);
 else if(kind==='pipeline'){
  addCell('import','source_frames=/path/to.csv&destination_frame=train');
  addCell('build','algo=gbm&training_frame=train&response_column=y&ntrees=20&model_id=flow_gbm');
  addCell('predict','model=flow_gbm&frame=train&predictions_frame=preds');
 }
}

// ---- browser panes ----------------------------------------------------
function paneItem(host, name, note){
 // DOM construction, not innerHTML: a hostile frame/model id must render
 // as TEXT, never as markup or a broken onclick (stored-XSS guard)
 const d = document.createElement('div');
 d.className = 'item';
 d.textContent = name + ' ';
 const sp = document.createElement('span');
 sp.style.color = '#9ab'; sp.textContent = note;
 d.appendChild(sp);
 d.onclick = () => addCell('inspect', name);
 host.appendChild(d);
}
async function refreshPanes(){
 try{
  const fh = document.getElementById('framelist'); fh.textContent='';
  (await J('/3/Frames')).frames.slice(0,40).forEach(f=>
   paneItem(fh, f.frame_id.name, `${f.rows}x${f.column_count}`));
  if(!fh.childElementCount) fh.textContent = 'none';
  const mh = document.getElementById('modellist'); mh.textContent='';
  (await J('/3/Models')).models.slice(0,40).forEach(m=>
   paneItem(mh, m.model_id, m.algo));
  if(!mh.childElementCount) mh.textContent = 'none';
 }catch(e){}
}

// ---- inline metric plot: scoring history as a plain SVG line ---------
function sparkline(hist){
 const key = hist[0].training_logloss!=null?'training_logloss':
             hist[0].training_rmse!=null?'training_rmse':
             Object.keys(hist[0]).find(k=>k.startsWith('training_'));
 if(!key) return '';
 const ys = hist.map(h=>h[key]).filter(v=>v!=null&&isFinite(v));
 if(ys.length<2) return '';
 const W=420,H=120,P=28;
 const lo=Math.min(...ys), hi=Math.max(...ys), span=(hi-lo)||1;
 const pts = ys.map((v,i)=>
  `${P+i*(W-2*P)/(ys.length-1)},${H-P-(v-lo)*(H-2*P)/span}`).join(' ');
 return `<svg width="${W}" height="${H}" role="img" aria-label="${key}">`+
  `<line x1="${P}" y1="${H-P}" x2="${W-P}" y2="${H-P}" stroke="#ccd" stroke-width="1"/>`+
  `<polyline points="${pts}" fill="none" stroke="#1b6ca8" stroke-width="2"/>`+
  `<text x="${P}" y="14" font-size="11" fill="#345">${key} (${ys[ys.length-1].toFixed(4)})</text>`+
  `<text x="${P}" y="${H-P+14}" font-size="10" fill="#89a">iterations &rarr;</text></svg>`;
}
function varimpBars(vi){
 // DOM construction like paneItem, not innerHTML: a hostile column name in
 // r.variable must render as TEXT inside the SVG, never as markup
 // (stored-XSS guard)
 const top = vi.slice(0,8);
 const W=420,BH=14,P=120, NS='http://www.w3.org/2000/svg';
 const svg = document.createElementNS(NS,'svg');
 svg.setAttribute('width',W); svg.setAttribute('height',top.length*(BH+4)+10);
 svg.setAttribute('role','img'); svg.setAttribute('aria-label','variable importances');
 top.forEach((r,i)=>{
  const rect = document.createElementNS(NS,'rect');
  rect.setAttribute('x',P); rect.setAttribute('y',6+i*(BH+4));
  rect.setAttribute('width',(W-P-10)*r.scaled_importance);
  rect.setAttribute('height',BH); rect.setAttribute('fill','#1b6ca8');
  svg.appendChild(rect);
  const t = document.createElementNS(NS,'text');
  t.setAttribute('x',P-6); t.setAttribute('y',17+i*(BH+4));
  t.setAttribute('font-size',10); t.setAttribute('fill','#345');
  t.setAttribute('text-anchor','end');
  t.textContent = r.variable;
  svg.appendChild(t);
 });
 return svg;
}
async function plotModel(i, modelId){
 try{
  const m = (await J('/3/Models/'+modelId)).models[0];
  const viz = document.getElementById('viz'+i);
  // sparkline interpolates only server-derived metric names, never ids
  viz.innerHTML = (m.scoring_history && m.scoring_history.length>1)
    ? sparkline(m.scoring_history) : '';
  if(m.variable_importances && m.variable_importances.length)
   viz.appendChild(varimpBars(m.variable_importances));
 }catch(e){}
}

async function runCell(i){
 const c = cells[i];
 c.src = document.getElementById('src'+i).value;
 const out = document.getElementById('out'+i);
 if (c.type==='markdown'){ mdRender(i); return; }
 out.style.display='block'; out.textContent='...';
 try {
  let r;
  if (c.type==='rapids'){
   const p=new URLSearchParams(); p.set('ast', c.src);
   r = await J('/99/Rapids',{method:'POST',body:p});
  } else if (c.type==='import'){
   const p=new URLSearchParams(c.src);
   const s=await J('/3/Parse',{method:'POST',body:p});
   r = await waitJob(s.job && s.job.key) || s;
  } else if (c.type==='build'){
   const p=new URLSearchParams(c.src);
   const algo=p.get('algo'); p.delete('algo');
   const s=await J('/3/ModelBuilders/'+algo,{method:'POST',body:p});
   r = await waitJob(s.job && s.job.key) || s;
   const mid = p.get('model_id') || (r && r.dest);
   if (mid) plotModel(i, mid);
  } else if (c.type==='predict'){
   const p=new URLSearchParams(c.src);
   r = await J(`/3/Predictions/models/${p.get('model')}/frames/${p.get('frame')}`,
     {method:'POST', body:new URLSearchParams({predictions_frame:p.get('predictions_frame')||'preds'})});
  } else if (c.type==='inspect'){
   const key = c.src.trim();
   try { r = (await J('/3/Models/'+key)).models[0]; plotModel(i, key); }
   catch(e){ r = (await J('/3/Frames/'+key+'/summary')).frames[0]; }
  }
  out.textContent = JSON.stringify(r, null, 1).slice(0, 4000);
  refreshPanes();
 } catch(e){ out.textContent = 'ERROR ' + e; }
}
async function waitJob(key){
 if(!key) return null;
 for(let i=0;i<600;i++){
  const j=(await J('/3/Jobs/'+encodeURIComponent(key))).jobs[0];
  if(['DONE','FAILED','CANCELLED'].includes(j.status)) return j;
  await new Promise(r=>setTimeout(r,400));
 }
 return {status:'TIMEOUT'};
}
async function runAll(){for(let i=0;i<cells.length;i++) await runCell(i);}

// ---- persistence: NPS documents + .flow JSON interchange -------------
async function saveNb(){
 const name=document.getElementById('nbname').value||'notebook1';
 const p=new URLSearchParams(); p.set('value', JSON.stringify(cells));
 await J('/3/NodePersistentStorage/notebooks/'+encodeURIComponent(name),{method:'POST',body:p});
 document.getElementById('status').textContent='saved '+new Date().toLocaleTimeString();
}
async function loadNb(){
 const name=document.getElementById('nbname').value||'notebook1';
 try{
  const r=await J('/3/NodePersistentStorage/notebooks/'+encodeURIComponent(name));
  cells=JSON.parse(r.value); render();
  document.getElementById('status').textContent='loaded';
 }catch(e){document.getElementById('status').textContent='not found';}
}
function exportFlow(){
 // reference .flow document shape: {version, cells:[{type:'cs'|'md', input}]}
 const doc = {version:'1.0.0', cells: cells.map(c=>(
  c.type==='markdown' ? {type:'md', input:c.src}
                      : {type:'cs', input:`${c.type} ${c.src}`}))};
 const a = document.createElement('a');
 a.href = URL.createObjectURL(new Blob([JSON.stringify(doc,null,1)],{type:'application/json'}));
 a.download = (document.getElementById('nbname').value||'notebook1')+'.flow';
 a.click();
}
function importFlow(file){
 if(!file) return;
 const rd = new FileReader();
 rd.onload = () => {
  try{
   const doc = JSON.parse(rd.result);
   const arr = doc.cells || doc;         // .flow doc or raw cell list
   cells = arr.map(c=>{
    if(c.type==='md') return {type:'markdown', src:c.input||c.src||''};
    if(c.type==='cs'){
     const inp=(c.input||'').trim();
     const sp=inp.indexOf(' ');
     const head=sp<0?inp:inp.slice(0,sp), rest=sp<0?'':inp.slice(sp+1);
     if(['rapids','import','build','predict','inspect'].includes(head))
      return {type:head, src:rest};
     return {type:'rapids', src:inp};    // foreign coffeescript cells
    }
    return {type:c.type||'rapids', src:c.src||c.input||''};
   });
   render();
   document.getElementById('status').textContent='imported '+file.name;
  }catch(e){document.getElementById('status').textContent='bad .flow: '+e;}
 };
 rd.readAsText(file);
}
render(); refreshPanes(); setInterval(refreshPanes, 7000);
</script></body></html>
"""


def h_notebook(h):
    _send_html(h, NOTEBOOK_HTML.encode())
